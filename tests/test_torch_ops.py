"""newmsm_tpu_torch ops (similarity, strain, histogram, resampling,
smoothing, unfolding) held against the JAX package on the same seeded
inputs."""
import numpy as np
import pytest

from newmsm_tpu.core.mesh import Mesh
from newmsm_tpu.ops import histogram as jhst
from newmsm_tpu.ops import resample as jrsp
from newmsm_tpu.ops import similarity as jsim
from newmsm_tpu.ops import strain as jstr
from newmsm_tpu.ops import unfold as junf

from newmsm_tpu_torch.ops import histogram as thst
from newmsm_tpu_torch.ops import resample as trsp
from newmsm_tpu_torch.ops import similarity as tsim
from newmsm_tpu_torch.ops import strain as tstr
from newmsm_tpu_torch.ops import unfold as tunf

from fixtures import smooth_pattern
from torch_helpers import assert_close_f32, both, np_, warped_icosphere


@pytest.mark.parametrize("simval", [1, 2, 4, 5])
def test_similarity_matches_jax(simval):
    # float32 reductions over <= 96 entries: rtol 1e-5 (atol 1e-6 for
    # values near 0); DICE/genDICE are counts and must match exactly
    rng = np.random.default_rng(simval)
    shape = (7, 5, 96)
    a, b = rng.normal(size=shape), rng.normal(size=shape)
    w = rng.uniform(0.2, 1.0, size=shape)
    mask = (rng.uniform(size=shape) > 0.2).astype(np.float32)
    mask[0, 0] = 0.0                     # an empty row
    ins = [both(x) for x in (a, b, w, mask)]
    if simval in (4, 5):
        args_j = (ins[0][0], ins[1][0], ins[3][0])
        args_t = (ins[0][1], ins[1][1], ins[3][1])
        out_j = jsim.dice(*args_j, generalised=simval == 5)
        out_t = tsim.dice(*args_t, generalised=simval == 5)
        np.testing.assert_allclose(np_(out_t), np_(out_j), rtol=1e-6)
    out_j = jsim.sim_for_min(*(x[0] for x in ins), simval)
    out_t = tsim.sim_for_min(*(x[1] for x in ins), simval)
    np.testing.assert_allclose(np_(out_t), np_(out_j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scale", [1.0, 5.0])
def test_triangular_strain_matches_jax(scale):
    rng = np.random.default_rng(0)
    orig = rng.normal(size=(200, 3, 3)) * 10 + np.array([0, 0, 100.0])
    final = orig + scale * rng.normal(size=orig.shape)
    oj, ot = both(orig)
    fj, ft = both(final)
    for k_exp in (2.0, 1.5):
        out_j = jstr.triangular_strain(oj, fj, 0.4, 1.6, k_exp)
        out_t = tstr.triangular_strain(ot, ft, 0.4, 1.6, k_exp)
        ref = tstr.triangular_strain(ot.double(), ft.double(), 0.4, 1.6,
                                     k_exp)
        assert_close_f32(out_t, out_j, ref)


def test_histogram_copy_matches_jax():
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(2, 500)), rng.gamma(2.0, size=(2, 400))
    excl = (rng.uniform(size=500) > 0.1).astype(float)
    np.testing.assert_array_equal(
        thst.multivariate_histogram_normalization(a, b, excl, None),
        jhst.multivariate_histogram_normalization(a, b, excl, None))
    np.testing.assert_array_equal(thst.variance_normalise(a, excl),
                                  jhst.variance_normalise(a, excl))


@pytest.mark.parametrize("with_excl", [False, True])
def test_metric_resample_matches_jax(with_excl):
    # ico-4 warped data mesh onto ico-3: atol 1e-4 on unit-variance data
    # (float32 sums of the area-corrected weights in another order)
    src = warped_icosphere(4, seed=5, deg=3.0)
    src.data = np.stack([smooth_pattern(src.coords, 1),
                         smooth_pattern(src.coords, 2)])
    low = Mesh.from_icosphere(3)
    excl = None
    if with_excl:
        excl = (smooth_pattern(src.coords, 9) > -1.0).astype(float)
    out_j, ex_j = jrsp.metric_resample(src, low, excl)
    out_t, ex_t = trsp.metric_resample(src, low, excl)
    np.testing.assert_allclose(out_t.data, out_j.data, atol=1e-4)
    if with_excl:
        np.testing.assert_allclose(ex_t, ex_j, atol=1e-4)


@pytest.mark.parametrize("with_excl", [False, True])
def test_smooth_data_matches_jax(with_excl):
    mesh = Mesh.from_icosphere(3)
    mesh.data = np.stack([smooth_pattern(mesh.coords, 3)])
    excl = ((smooth_pattern(mesh.coords, 4) > -0.8).astype(float)
            if with_excl else None)
    out_j, ex_j = jrsp.smooth_data(mesh, 2.0, excl)
    out_t, ex_t = trsp.smooth_data(mesh, 2.0, excl)
    np.testing.assert_allclose(out_t.data, out_j.data, atol=1e-4)
    if with_excl:
        np.testing.assert_allclose(ex_t, ex_j, atol=1e-4)


def test_sphere_project_warp_and_nearest_neighbour():
    # warped positions agree to 1e-3 at RAD=100 (float32 barycentrics)
    frm = Mesh.from_icosphere(3)
    to = warped_icosphere(3, seed=8, deg=4.0)
    sphere = Mesh.from_icosphere(4)
    out_j = jrsp.sphere_project_warp(sphere, frm, to)
    out_t = trsp.sphere_project_warp(sphere, frm, to)
    np.testing.assert_allclose(out_t.coords, out_j.coords, atol=1e-3)

    src = warped_icosphere(4, seed=6, deg=3.0)
    src.data = smooth_pattern(src.coords, 5)[None]
    excl = (smooth_pattern(src.coords, 6) > -1.0).astype(float)
    nn_j, ex_j = jrsp.nearest_neighbour_interpolation(src, frm, excl)
    nn_t, ex_t = trsp.nearest_neighbour_interpolation(src, frm, excl)
    np.testing.assert_array_equal(nn_t.data, nn_j.data)
    np.testing.assert_array_equal(ex_t, ex_j)


def _folded_sphere():
    """ico-3 sphere with a few vertices dragged across their neighbours:
    forced folds."""
    mesh = Mesh.from_icosphere(3)
    rng = np.random.default_rng(4)
    nbr = mesh.adjacency[0]
    for v in rng.choice(mesh.nvertices, 6, replace=False):
        far = nbr[nbr[v][0]][0]
        mesh.coords[v] = mesh.coords[v] + 1.6 * (mesh.coords[far]
                                                 - mesh.coords[v])
    mesh.true_rescale(100.0)
    return mesh


def test_unfold_matches_jax():
    """Both packages remove every fold of the same fixture with the same
    sweep cadence; coordinates agree to 1e-3 at RAD = 100."""
    mesh = _folded_sphere()
    assert junf.count_folds(mesh) > 0
    assert tunf.count_folds(mesh) == junf.count_folds(mesh)
    out_j = junf.unfold(mesh)
    out_t = tunf.unfold(mesh)
    assert junf.count_folds(out_j) == 0
    assert tunf.count_folds(out_t) == 0
    np.testing.assert_allclose(out_t.coords, out_j.coords, atol=1e-3)
