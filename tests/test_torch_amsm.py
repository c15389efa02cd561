"""The anatomical (aMSM, regoption 5) pieces of newmsm_tpu_torch held
against the JAX package: synthetic inputs, anatomical resampling, the
static aMSM tables, the anatomical triplet cost, the vertex strain maps,
the quality metrics, and the whole regoption 5 + triclique run through
both CLIs."""
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from newmsm_tpu.core.mesh import Mesh
from newmsm_tpu.eval import metrics as JEM
from newmsm_tpu.eval import synth as JSY
from newmsm_tpu.ops import resample as JRS
from newmsm_tpu.ops import strain as JST
from newmsm_tpu.reg import costs as JC
from newmsm_tpu.reg import driver as JD
from newmsm_tpu.reg import model as JM
from newmsm_tpu.reg import strains_output as JSO
from newmsm_tpu.reg.config import RegConfig

from newmsm_tpu_torch import convert
from newmsm_tpu_torch.core import spherical as TSPH
from newmsm_tpu_torch.eval import metrics as TEM
from newmsm_tpu_torch.eval import synth as TSY
from newmsm_tpu_torch.ops import resample as TRS
from newmsm_tpu_torch.ops import strain as TST
from newmsm_tpu_torch.reg import costs as TC
from newmsm_tpu_torch.reg import driver as TD
from newmsm_tpu_torch.reg import strains_output as TSO

from torch_helpers import (assert_close_f32, np_, run_variant_pair,
                           warped_icosphere)

RES, CP_RES, ANAT_RES, SG_RES = 3, 1, 2, 3
STRAIN = (0.2, 0.4, 1.6, 2.0, 2.0)      # lambda, mu, kappa, k_exp, rexp


@pytest.fixture(scope="module")
def pair():
    """longitudinal_pair(3): spheres, one sulc channel, two anatomies."""
    return JSY.longitudinal_pair(RES, seed=0)


def test_new_synth_functions_equal_jax():
    """longitudinal_pair and multimodal_cohort: equal arrays for the same
    seed (both are numpy; 1e-12 covers nothing but summation order)."""
    a = JSY.longitudinal_pair(2, seed=3)
    b = TSY.longitudinal_pair(2, seed=3)
    assert len(a) == len(b) == 6
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_allclose(y, x, atol=1e-12)
        else:
            np.testing.assert_allclose(y.coords, x.coords, atol=1e-12)
            np.testing.assert_array_equal(y.faces, x.faces)
    mj, dj, tj = JSY.multimodal_cohort(2, 2, n_channels=5, seed=1)
    mt, dt, tt = TSY.multimodal_cohort(2, 2, n_channels=5, seed=1)
    np.testing.assert_allclose(tt, tj, atol=1e-12)
    assert tt.shape == (5, 162)
    for x, y in zip(dj, dt):
        np.testing.assert_allclose(y, x, atol=1e-12)


def test_metrics_equal_jax(pair):
    """eval.metrics: CC / DICE and their pairwise means equal (numpy both
    sides); distortion maps and stats to 1e-6 (the JAX package forms the
    face frames in float32, the port in float64)."""
    rng = np.random.default_rng(0)
    maps = [rng.normal(size=(2, 642)) for _ in range(3)]
    a, b = maps[0][0], maps[1][0] + 0.5 * maps[0][0]
    assert TEM.cross_correlation(a, b) == JEM.cross_correlation(a, b)
    assert TEM.dice_overlap(a, b) == JEM.dice_overlap(a, b)
    ch = [m[0] for m in maps]
    assert TEM.mean_pairwise_cc(ch) == JEM.mean_pairwise_cc(ch)
    assert TEM.mean_pairwise_dice(ch) == JEM.mean_pairwise_dice(ch)
    orig = Mesh.from_icosphere(RES)
    reg = warped_icosphere(RES, seed=4, deg=3.0)
    aj, sj = JEM.distortion_maps(orig, reg)
    at, st = TEM.distortion_maps(convert.mesh(orig), convert.mesh(reg))
    np.testing.assert_allclose(at, aj, atol=1e-6)
    np.testing.assert_allclose(st, sj, atol=1e-6)
    dj, dt = JEM.distortion_stats(aj, sj), TEM.distortion_stats(at, st)
    assert dj.keys() == dt.keys()
    for k in dj:
        assert dt[k] == pytest.approx(dj[k], abs=1e-6), k
    assert dj["areal_mean"] > 1e-3


def test_spherical_additions_match_jax():
    """geodesic, same_side, point_in_triangle, barycentric_interp on seeded
    points: 1e-4 at RAD = 100 / equal booleans; principal_strains_2d to the
    strain tolerance (rtol 2e-4)."""
    from newmsm_tpu.core import spherical as JSPH
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(5, 64, 3)).astype(np.float32) * 10.0
    J = [jnp.asarray(p) for p in pts]
    T = [torch.from_numpy(p) for p in pts]
    np.testing.assert_allclose(np_(TSPH.geodesic(T[0], T[1])),
                               np_(JSPH.geodesic(J[0], J[1])), atol=1e-4)
    np.testing.assert_array_equal(
        np_(TSPH.same_side(T[0], T[1], T[2], T[3])),
        np_(JSPH.same_side(J[0], J[1], J[2], J[3])))
    np.testing.assert_array_equal(
        np_(TSPH.point_in_triangle(T[0], T[1], T[2], T[3])),
        np_(JSPH.point_in_triangle(J[0], J[1], J[2], J[3])))
    f = rng.normal(size=(3, 64, 2)).astype(np.float32)
    np.testing.assert_allclose(
        np_(TSPH.barycentric_interp(T[1], T[2], T[3], T[0],
                                    *(torch.from_numpy(x) for x in f))),
        np_(JSPH.barycentric_interp(J[1], J[2], J[3], J[0],
                                    *(jnp.asarray(x) for x in f))), atol=1e-4)
    # near-equilateral triangles under a mild linear map (a random
    # triangle makes the 3x3 solve ill-conditioned)
    ax = np.array([0.0, 1.0, 0.5]) + 0.05 * rng.normal(size=(64, 3))
    ay = np.array([0.0, 0.0, 0.9]) + 0.05 * rng.normal(size=(64, 3))
    xy = np.stack([ax, ay, 1.1 * ax + 0.1 * ay, 0.95 * ay - 0.05 * ax]
                  ).astype(np.float32)
    ej = JST.principal_strains_2d(*(jnp.asarray(x) for x in xy))
    et = TST.principal_strains_2d(*(torch.from_numpy(x) for x in xy))
    e64 = TST.principal_strains_2d(*(torch.from_numpy(x).double() for x in xy))
    for a, b, c in zip(et, ej, e64):
        assert_close_f32(a, b, c, rtol=2e-4, atol=1e-5)
    n = torch.from_numpy(pts[0])
    for a, b in zip(TST._tangent_frame(n), JST._tangent_frame(J[0])):
        np.testing.assert_allclose(np_(a), np_(b), atol=1e-6)


def test_anatomical_resampling_matches_jax(pair):
    """surface_resample (anatomy onto a lower icosphere) and
    project_anatomical_mesh (anatomy carried through a warp): coordinates to
    1e-3 at anatomical radii of ~100 (positions 1e-4 relative, as the
    port's other resampling tests)."""
    in_mesh, _, in_anat, ref_mesh, _, ref_anat = pair
    low = Mesh.from_icosphere(ANAT_RES)
    rj = JRS.surface_resample(in_anat, in_mesh, low)
    rt = TRS.surface_resample(convert.mesh(in_anat), convert.mesh(in_mesh),
                              convert.mesh(low), device="cpu")
    np.testing.assert_allclose(rt.coords, rj.coords, atol=1e-3)
    np.testing.assert_array_equal(rt.faces, rj.faces)
    warped = warped_icosphere(RES, seed=6, deg=3.0)
    pj = JRS.project_anatomical_mesh(warped, ref_mesh, ref_anat)
    pt = TRS.project_anatomical_mesh(convert.mesh(warped),
                                     convert.mesh(ref_mesh),
                                     convert.mesh(ref_anat), device="cpu")
    np.testing.assert_allclose(pt.coords, pj.coords, atol=1e-3)
    assert np.abs(pj.coords - ref_anat.coords).max() > 1.0


def _anat_config():
    cfg = RegConfig()
    cfg.cost = ["DISCRETE"]
    cfg.cpgrid, cfg.anatgrid, cfg.datagrid = [CP_RES], [ANAT_RES], [RES]
    cfg.regmode = 5
    return cfg


@pytest.fixture(scope="module")
def anat_tables(pair):
    """The static aMSM tables of both drivers for CP ico-1 / anat ico-2."""
    in_mesh, in_data, in_anat, ref_mesh, ref_data, ref_anat = pair
    out = []
    for D, kw, conv in ((JD, {}, lambda m: m),
                        (TD, {"device": "cpu"}, convert.mesh)):
        mr = D.MeshRegistration(**kw)
        mr.set_input(conv(in_mesh))
        mr.set_reference(conv(ref_mesh))
        mr.set_anatomical(conv(in_anat), conv(ref_anat))
        mr.cfg = _anat_config()
        control = conv(Mesh.from_icosphere(CP_RES))
        out.append(mr._resample_anatomy(0, control))
    return out


def test_resample_anatomy_tables_match_jax(anat_tables):
    """The vectorised parent assignment keeps the reference loop's "last
    parent wins" on shared boundary vertices: lineage, faces and parent ids
    equal; barycentrics 1e-5; resampled anatomies 1e-3."""
    aj, at = anat_tables
    for name in ("lineage", "anat_faces", "anat_parent"):
        np.testing.assert_array_equal(np_(getattr(at, name)),
                                      np_(getattr(aj, name)), err_msg=name)
    np.testing.assert_allclose(np_(at.anat_bary), np_(aj.anat_bary), atol=1e-5)
    np.testing.assert_allclose(np_(at.anat_bary).sum(1), 1.0, atol=1e-5)
    np.testing.assert_allclose(np_(at.anat_orig), np_(aj.anat_orig), atol=1e-3)
    np.testing.assert_allclose(np_(at.anat_target), np_(aj.anat_target),
                               atol=1e-3)
    assert at.anat_sphere.pristine_res == ANAT_RES
    carried = convert.anat_tables(aj, device="cpu")
    assert carried.anat_sphere.pristine_res == ANAT_RES
    np.testing.assert_array_equal(np_(carried.anat_parent),
                                  np_(at.anat_parent))


def test_anatomical_triplet_costs_match_jax(pair, anat_tables):
    """The (T,C) regoption-5 cost from identical state and the JAX
    package's tables carried over (convert.anat_tables): rtol 2e-4 (float32
    strain, see assert_close_f32) with atol 1e-4 for the near-zero
    entries; equal FOLDING entries. Its queries to the anatomical sphere
    are raw barycentric combinations, off the sphere."""
    in_mesh, in_data, _, ref_mesh, ref_data, _ = pair
    control = Mesh.from_icosphere(CP_RES)
    kw = dict(simval=2, reglambda=STRAIN[0], sg_res=SG_RES, regmode=5)
    jm = JM.PairwiseModel(JM.ModelConfig(bucket_labels=False, **kw), control,
                          in_mesh, ref_mesh, in_data, ref_data)
    sj = jm.setup_iteration(np.ones((1, in_mesh.nvertices)))
    st = convert.iteration_state({k: np.asarray(v) for k, v in sj.items()},
                                 device="cpu")
    lt = convert.level_tables(jm.tables, device="cpu")
    aj = anat_tables[0]
    at = convert.anat_tables(aj, device="cpu")
    T, L = jm.tables.triplets.shape[0], jm.num_labels
    rng = np.random.default_rng(3)
    la, lb, lc = (rng.integers(0, L, size=(T, 8)) for _ in range(3))
    cj = JC.anatomical_triplet_costs(
        sj["cp"], sj["rl"], jm.tables, aj, jnp.asarray(la), jnp.asarray(lb),
        jnp.asarray(lc), *STRAIN)
    args = (torch.from_numpy(la), torch.from_numpy(lb), torch.from_numpy(lc))
    ct = TC.anatomical_triplet_costs(st["cp"], st["rl"], lt, at, *args,
                                     *STRAIN)
    at64 = at._replace(anat_bary=at.anat_bary.double(),
                       anat_target=at.anat_target.double(),
                       anat_orig=at.anat_orig.double())
    c64 = TC.anatomical_triplet_costs(st["cp"].double(), st["rl"].double(),
                                      lt, at64, *args, *STRAIN)
    assert ct.shape == (T, 8)
    fold = 1e7 * STRAIN[0]
    np.testing.assert_array_equal(np_(ct) == fold, np_(cj) == fold)
    assert_close_f32(ct, cj, c64, rtol=2e-4, atol=1e-4)
    assert np.ptp(np_(cj)[np_(cj) < fold]) > 1e-3


def test_vertex_strains_match_loop_oracle_and_jax(pair):
    """vertex_strains (vectorised, float64 on the host) against its own
    per-vertex loop (1e-9) and against the JAX package (rtol 2e-4: its
    tangent bases pass through float32)."""
    _, _, in_anat, _, _, ref_anat = pair
    orig, final = convert.mesh(in_anat), convert.mesh(ref_anat)
    vt = TSO.vertex_strains(orig, final)
    assert vt.shape == (4, orig.nvertices) and np.isfinite(vt).all()
    idx = np.arange(0, orig.nvertices, 7)
    loop, _ = TSO._vertex_strains_loop(orig, final, only=idx)
    np.testing.assert_allclose(vt[:, idx], loop, rtol=1e-9, atol=1e-9)
    vj = JSO.vertex_strains(in_anat, ref_anat)
    np.testing.assert_allclose(vt, vj, rtol=2e-4, atol=1e-6)
    m = TSO.vertex_strains_mesh(orig, final)
    np.testing.assert_array_equal(m.data, vt)
    np.testing.assert_array_equal(m.coords, final.coords)


def test_amsm_triclique_driver_matches_jax_through_the_cli(tmp_path):
    """Whole driver through both CLIs with --inanat/--refanat, regoption 5
    + triclique at ico-3 (CP 1/2, anatgrid 2/3): both write
    anat.reg.surf.gii and a finite 4-row STRAINS.func.gii, are fold-free,
    raise the sulc CC, and end within 0.01 CC of each other; the port also
    writes a torch.profiler trace (--profile)."""
    out = run_variant_pair(tmp_path, "amsm", cc_tol=0.01)
    trace = json.load(open(out["profile"] + "/trace.json"))
    assert len(trace["traceEvents"]) > 100
