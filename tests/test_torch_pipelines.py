"""The cohort layer of newmsm_tpu_torch (pipelines.gmsm, pipelines.cohort,
eval.reports, tools.resample_tools, core.sparse, MeshRegistration.is_sparse)
against the JAX package, on the CPU. Each tolerance is stated in its test.
Group runs use a template rotated off the data grid and cprange 1.1 (see
tests/test_torch_group.py on ties)."""
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from newmsm_tpu.core import io as jio
from newmsm_tpu.core import sparse as jsparse
from newmsm_tpu.core.mesh import Mesh
from newmsm_tpu.pipelines import gmsm as jgmsm
from newmsm_tpu.tools.resample_tools import main as jtools_main

from newmsm_tpu_torch import convert
from newmsm_tpu_torch.core import sparse as tsparse
from newmsm_tpu_torch.core.mesh import Mesh as TMesh
from newmsm_tpu_torch.ops.unfold import count_folds as tfolds
from newmsm_tpu_torch.pipelines import cohort as tcohort
from newmsm_tpu_torch.pipelines import gmsm as tgmsm
from newmsm_tpu_torch.tools.resample_tools import main as ttools_main

from fixtures import rotation_matrix, smooth_pattern
from test_group import group_config, make_group, mean_pairwise_corr
from test_sparse_connectivity import random_connectome
from test_torch_group import rotated_template, torch_config
from torch_helpers import warped_icosphere


def _cfg(iters=2):
    cfg = group_config(iters=iters)
    cfg.cprange = 1.1
    return cfg


# ------------------------------------------------------------------ dedrift

def test_dedrift_removes_a_common_rotation():
    """As tests/test_eval_pipelines.py:45: three spheres that share one
    8-degree rotation come back within 1.5 of the original; and within
    1e-3 of the JAX package's dedrifted spheres."""
    orig = Mesh.from_icosphere(3)
    R = rotation_matrix([0, 0, 1], 8.0)
    warped = []
    for _ in range(3):
        m = orig.copy()
        m.coords = m.coords @ R.T
        warped.append(m)
    want = jgmsm.dedrift(warped, orig)
    got = tgmsm.dedrift([convert.mesh(m) for m in warped], convert.mesh(orig),
                        device="cpu")
    for g, w in zip(got, want):
        assert np.abs(g.coords - orig.coords).max() < 1.5
        np.testing.assert_allclose(g.coords, w.coords, atol=1e-3)
        assert tfolds(g, device="cpu") == 0


def test_dedrift_keeps_the_differences_between_subjects():
    """Two subjects rotated by +6 and -6 degrees about one axis have no
    common drift: dedrift leaves each within 0.5 of where it was."""
    orig = TMesh.from_icosphere(3)
    out = []
    for deg in (6.0, -6.0):
        m = orig.copy()
        m.coords = m.coords @ rotation_matrix([0, 1, 0], deg).T
        out.append(m)
    ded = tgmsm.dedrift(out, orig, device="cpu")
    for before, after in zip(out, ded):
        assert np.abs(after.coords - before.coords).max() < 0.5


# --------------------------------------------------------- gMSM and cgMSM

def test_run_gmsm_matches(tmp_path):
    """One gMSM group run in both packages (the port's fusion starts from
    its own seeded generator): the same stats keys, CC above before and
    within 0.02 of the JAX package's, mean / stdev maps written."""
    meshes, datasets = make_group(3, degrees=8.0)
    tmpl = rotated_template()
    want = jgmsm.run_gmsm(meshes, datasets, tmpl, _cfg(),
                          outdir=str(tmp_path / "j") + "/")
    got = tgmsm.run_gmsm([convert.mesh(m) for m in meshes], datasets,
                         convert.mesh(tmpl), torch_config(_cfg()),
                         outdir=str(tmp_path / "t") + "/", device="cpu")
    assert set(got.stats) == set(want.stats)
    assert set(got.stats) == {"cc", "dice", "areal_mean", "areal_max",
                              "areal_95", "areal_98", "shape_mean",
                              "shape_max"}
    before = mean_pairwise_corr(datasets)
    assert got.stats["cc"] > before
    assert abs(got.stats["cc"] - want.stats["cc"]) <= 0.02, (got.stats,
                                                             want.stats)
    assert got.mean_map.shape == want.mean_map.shape == (1, 642)
    assert np.isfinite(got.stdev_map).all()
    assert len(got.dedrifted_spheres) == len(got.resampled_data) == 3
    for name in ("mean.func.gii", "stdev.func.gii",
                 "sphere-0.dedrift.reg.surf.gii", "sphere-0.reg.surf.gii"):
        assert os.path.exists(str(tmp_path / "t" / name)), name
    for m in got.dedrifted_spheres:
        assert tfolds(m, device="cpu") == 0


def test_run_gmsm_without_outdir_leaves_no_files(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    meshes, datasets = make_group(2, degrees=6.0)
    res = tgmsm.run_gmsm([convert.mesh(m) for m in meshes], datasets,
                         convert.mesh(rotated_template()),
                         torch_config(_cfg(iters=1)), dedrift_warps=False,
                         device="cpu")
    assert np.isfinite(res.stats["cc"]) and os.listdir(tmp_path) == []


def test_run_cgmsm_on_a_two_leaf_tree(tmp_path, monkeypatch):
    """Two groups of two subjects under one root, in both packages: the
    root holds all four members, and the root's mean maps correlate above
    0.98 (each package's own fusion starts). (The node registrations write
    their spheres under the default prefix "./", as the reference does.)"""
    monkeypatch.chdir(tmp_path)
    meshes, datasets = make_group(4, degrees=6.0)
    groups = {"A": [0, 1], "B": [2, 3]}
    tmpl = rotated_template()
    want = jgmsm.run_cgmsm(groups, [("A", "B", "AB")],
                           {i: (meshes[i], datasets[i]) for i in range(4)},
                           tmpl, _cfg())
    got = tgmsm.run_cgmsm(
        groups, [("A", "B", "AB")],
        {i: (convert.mesh(meshes[i]), datasets[i]) for i in range(4)},
        convert.mesh(tmpl), torch_config(_cfg()), device="cpu")
    assert set(got) == set(want) == {"A", "B", "AB"}
    assert set(got["AB"]["members"]) == {0, 1, 2, 3}
    assert got["AB"]["mean"].shape == want["AB"]["mean"].shape == (1, 642)
    np.testing.assert_allclose(got["A"]["mean"], want["A"]["mean"], atol=1e-4)
    cc = np.corrcoef(got["AB"]["mean"][0], want["AB"]["mean"][0])[0, 1]
    assert cc > 0.98, cc
    for sid in range(4):
        assert tfolds(got["AB"]["meshes"][sid], device="cpu") == 0


def test_run_cohort_from_the_csv_inputs(tmp_path, monkeypatch):
    """As tests/test_cohort.py::TestRunCohort on the port."""
    monkeypatch.chdir(tmp_path)
    meshes, datasets = make_group(4, res=3, degrees=6.0)
    subs = {f"s{i}": (convert.mesh(meshes[i]), datasets[i]) for i in range(4)}
    extra = TMesh.from_icosphere(3)
    subs["tiny"] = (extra, smooth_pattern(extra.coords, 9)[None, :])
    groups = {"G1": ["s0", "s1"], "G2": ["s2", "s3"], "G3": ["tiny"]}
    hierarchy = [("G1", "G2", "N1"), ("N1", "G3", "ROOT")]
    template = convert.mesh(rotated_template())
    result = tcohort.run_cohort(groups, hierarchy, "ROOT", subs, template,
                                torch_config(_cfg()), min_size=2,
                                device="cpu")
    assert result.study.tree == [("G1", "G2", "N1")]
    assert all(isinstance(v, dict) for v in result.state.values())
    assert set(result["N1"]["members"]) == {"s0", "s1", "s2", "s3"}
    assert result["N1"]["mean"].shape[-1] == template.nvertices
    with pytest.raises(ValueError, match="missing study subjects"):
        tcohort.run_cohort(groups, hierarchy, "ROOT", {}, template,
                           torch_config(_cfg()), min_size=2, device="cpu")


# --------------------------------------------------------- register_dataset

def _pair_config():
    from newmsm_tpu_torch.reg.config import RegConfig
    cfg = RegConfig()
    cfg.cost = ["DISCRETE"]
    cfg.simval = [2]
    cfg.iters = [2]
    cfg.sigma_in = [0.0]
    cfg.sigma_ref = [0.0]
    cfg.reglambda = [0.1]
    cfg.datagrid = [3]
    cfg.cpgrid = [1]
    cfg.sampgrid = [3]
    cfg.anatgrid = [3]
    cfg.mciters = [50]
    cfg.dopt = "HOCR"
    cfg.regmode = 3
    return cfg


def test_register_dataset_isolates_a_failing_subject(tmp_path):
    """One good and one failing subject in a batch: the good one is
    registered (files written, CC above 0.4 as in tests/test_cohort.py),
    the bad one is reported and stops nothing."""
    mesh = TMesh.from_icosphere(3)
    template = smooth_pattern(mesh.coords, seed=3)[None, :]
    R = rotation_matrix([0.3, 1.0, 0.2], 8.0)
    good = smooth_pattern(mesh.coords @ R.T, seed=3)[None, :]

    def get(subject):
        if subject == "bad":
            raise RuntimeError("corrupt input")
        return good

    out = str(tmp_path) + "/"
    res = tcohort.register_dataset(["bad", "subA"], mesh, template,
                                   _pair_config(), get, outdir=out,
                                   device="cpu")
    assert res.failed == {"bad": "corrupt input"}
    assert set(res.per_subject) == {"subA"}
    st = res.per_subject["subA"]
    assert st["cc"] > 0.4 and {"areal_mean", "shape_mean"} <= set(st)
    assert os.path.exists(out + "subA.MSM.sphere.reg.surf.gii")
    assert os.path.exists(out + "subA.MSM.sphere.distortion.func.gii")
    assert not os.path.exists(out + "bad.MSM.sphere.reg.surf.gii")


def test_register_dataset_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mesh = TMesh.from_icosphere(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcohort.register_dataset(["a"], mesh, np.zeros((1, 162)),
                                 _pair_config(), {"a": np.zeros((1, 162))})


# -------------------------------------------------------------------- tools

def _tool_inputs(d):
    hi = warped_icosphere(4, seed=2, deg=3.0)
    hi.save(str(d / "hi.surf.gii"))
    Mesh(coords=hi.coords, faces=hi.faces,
         data=np.stack([smooth_pattern(hi.coords, 1),
                        smooth_pattern(hi.coords, 2)])).save(
        str(d / "hi.func.gii"))
    lo = Mesh.from_icosphere(3)
    lo.save(str(d / "lo.surf.gii"))
    grid = Mesh.from_icosphere(2)
    rot = grid.copy()
    rot.coords = grid.coords @ rotation_matrix([0, 1, 0], 5.0).T
    grid.save(str(d / "g.surf.gii"))
    rot.save(str(d / "r.surf.gii"))
    anat = hi.copy()
    anat.coords = hi.coords * (1.0 + 0.1 * smooth_pattern(hi.coords, 4))[:, None]
    anat.save(str(d / "anat.surf.gii"))
    return lo


TOOL_CASES = {
    "metric-resample": (["hi.surf.gii", "hi.func.gii", "lo.surf.gii"],
                        "func.gii"),
    "nn-resample": (["hi.surf.gii", "hi.func.gii", "lo.surf.gii"],
                    "func.gii"),
    "smoothing": (["hi.surf.gii", "hi.func.gii", "4.0"], "func.gii"),
    "applywarp": (["lo.surf.gii", "g.surf.gii", "r.surf.gii"], "surf.gii"),
    "surface-resample": (["anat.surf.gii", "hi.surf.gii", "lo.surf.gii"],
                         "surf.gii"),
}


@pytest.mark.parametrize("tool", list(TOOL_CASES))
def test_tools_match_the_reference_files(tmp_path, tool):
    """Each tool of both packages on the same files: outputs within 1e-4
    (data) / 1e-3 at radius 100 (coordinates: 1e-5 relative)."""
    lo = _tool_inputs(tmp_path)
    names, suffix = TOOL_CASES[tool]
    args = [a if a[0].isdigit() else str(tmp_path / a) for a in names]
    jout, tout = (str(tmp_path / f"{k}.{suffix}") for k in "jt")
    assert jtools_main([tool, *args, jout]) == 0
    assert ttools_main(["--device", "cpu", tool, *args, tout]) == 0
    if suffix == "func.gii":
        on = lo if tool != "smoothing" else Mesh.load(
            str(tmp_path / "hi.surf.gii"))
        want, got = jio.load_data(jout, on), jio.load_data(tout, on)
        assert got.shape == want.shape and got.shape[0] == 2
        np.testing.assert_allclose(got, want, atol=1e-4)
    else:
        want, got = Mesh.load(jout), Mesh.load(tout)
        np.testing.assert_array_equal(got.faces, want.faces)
        np.testing.assert_allclose(got.coords, want.coords, atol=1e-3)


def test_tools_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _tool_inputs(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttools_main(["applywarp", str(tmp_path / "lo.surf.gii"),
                     str(tmp_path / "g.surf.gii"),
                     str(tmp_path / "r.surf.gii"),
                     str(tmp_path / "w.surf.gii")])


# ------------------------------------------------------------------- sparse

def test_load_sparse_matches(tmp_path):
    rng = np.random.default_rng(0)
    r = rng.integers(1, 20, 40)
    c = rng.integers(1, 15, 40)
    v = rng.normal(size=40)
    path = tmp_path / "mat.txt"
    with open(path, "w") as f:
        for i in range(40):
            f.write(f"{r[i]} {c[i]} {v[i]:.8f}\n")
        f.write("20 15 0\n")
    got, want = tsparse.load_sparse(str(path)), jsparse.load_sparse(str(path))
    assert sp.issparse(got) and got.shape == want.shape == (20, 15)
    np.testing.assert_array_equal(got.toarray(), want.toarray())


def test_resample_columns_matches():
    """Within 1e-4 of the JAX package's sparse product and of the port's
    dense metric_resample."""
    from newmsm_tpu_torch.ops.resample import metric_resample
    src = Mesh.from_icosphere(3)
    src.true_rescale(100.0)
    dst = warped_icosphere(2, seed=4, deg=3.0)
    C = random_connectome(50, src.nvertices, 5)
    want = jsparse.resample_columns(C, src, dst)
    tsrc, tdst = convert.mesh(src), convert.mesh(dst)
    got = tsparse.resample_columns(C, tsrc, tdst, device="cpu")
    assert sp.issparse(got) and got.shape == (50, dst.nvertices)
    np.testing.assert_allclose(got.toarray(), want.toarray(), atol=1e-4)
    carrier = TMesh(coords=tsrc.coords, faces=tsrc.faces, data=C.toarray())
    dense, _ = metric_resample(carrier, tdst, device="cpu")
    np.testing.assert_allclose(got.toarray(), dense.data, atol=1e-4)


def test_smooth_columns_matches():
    """Within 1e-4 (it is host scipy in both; equal to rounding)."""
    m = Mesh.from_icosphere(2)
    m.true_rescale(100.0)
    C = random_connectome(30, m.nvertices, 4)
    got = tsparse.smooth_columns(C, convert.mesh(m), sigma=8.0)
    want = jsparse.smooth_columns(C, m, sigma=8.0)
    np.testing.assert_allclose(got.toarray(), want.toarray(), atol=1e-4)


def test_pearson_window_and_seed_features_exact():
    C = random_connectome(200, 30, 8, seed=1)
    ia, ib = np.arange(10), np.arange(10, 20)
    np.testing.assert_array_equal(tsparse.pearson_columns(C, C, ia, ib),
                                  jsparse.pearson_columns(C, C, ia, ib))
    rows = np.array([3, 50, 199])
    np.testing.assert_array_equal(tsparse.window(C, rows),
                                  jsparse.window(C, rows))
    np.testing.assert_array_equal(tsparse.seed_features(C, rows),
                                  jsparse.seed_features(C, rows))


def test_is_sparse_reads_spconvert_data(tmp_path):
    """MeshRegistration.is_sparse: data files are read as spconvert
    triplets (dense (D,N), transposed when stored (N,D)), in both
    packages."""
    from newmsm_tpu.reg.driver import MeshRegistration as JReg
    from newmsm_tpu_torch.reg.driver import MeshRegistration as TReg
    mesh = Mesh.from_icosphere(1)
    rng = np.random.default_rng(3)
    dense = np.where(rng.random((42, 3)) < 0.5, rng.normal(size=(42, 3)), 0.0)
    dense[-1, -1] = 1.5
    path = tmp_path / "conn.txt"
    with open(path, "w") as f:
        for i, j in zip(*np.nonzero(dense)):
            f.write(f"{i + 1} {j + 1} {dense[i, j]:.10f}\n")
        f.write("42 3 0\n")
    j = JReg()
    j.set_input(mesh)
    j.is_sparse()
    j.set_input_data(str(path))
    t = TReg(device="cpu")
    t.set_input(convert.mesh(mesh))
    t.is_sparse()
    t.set_input_data(str(path))
    t.set_reference(convert.mesh(mesh))
    t.set_reference_data(str(path))
    assert t.in_data.shape == (3, 42)
    np.testing.assert_allclose(t.in_data, dense.T, atol=1e-9)
    np.testing.assert_array_equal(t.in_data, j.in_data)
    np.testing.assert_array_equal(t.ref_data, t.in_data)
    t.is_sparse(False)
    with pytest.raises(ValueError):
        t.set_input_data(str(path))
