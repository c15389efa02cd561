"""The port's own host modules (core.icosphere, core.mesh, core.io,
reg.config, reg.sampling_grid, reg.optimise.coloring, eval.synth,
pipelines.cohort, eval.reports) against
the JAX package's modules they are copies of, and the port's whole-array
table code against the per-vertex loops it replaces (kept here as the
oracle). Integer tables are held to equality; float tolerances are stated
per case."""
import dataclasses
import importlib
import pathlib
import sys

import numpy as np
import pytest
import torch

from newmsm_tpu.core import io as jio
from newmsm_tpu.core.mesh import Mesh as JMesh
from newmsm_tpu.core.mesh import create_exclusion as j_create_exclusion
from newmsm_tpu.eval import synth as jsynth
from newmsm_tpu.reg import config as jconfig
from newmsm_tpu.reg import costs as JC
from newmsm_tpu.reg import sampling_grid as jsg
from newmsm_tpu.reg.optimise import coloring as jcol

from newmsm_tpu_torch import convert
from newmsm_tpu_torch.core import io as tio
from newmsm_tpu_torch.core.mesh import Mesh as TMesh
from newmsm_tpu_torch.core.mesh import create_exclusion as t_create_exclusion
from newmsm_tpu_torch.eval import synth as tsynth
from newmsm_tpu_torch.ops import nearest as tnst
from newmsm_tpu_torch.reg import config as tconfig
from newmsm_tpu_torch.reg import costs as TC
from newmsm_tpu_torch.reg import sampling_grid as tsg
from newmsm_tpu_torch.reg.optimise import coloring as tcol

from fixtures import smooth_pattern
from test_parity import typical_config
from test_torch_slice import TYPICAL_CONFIG_TEXT
from torch_helpers import warped_icosphere

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")

# `newmsm_tpu.core` re-exports the function `icosphere` over the module name
jico = importlib.import_module("newmsm_tpu.core.icosphere")
tico = importlib.import_module("newmsm_tpu_torch.core.icosphere")


def _equal_int(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ copied modules

@pytest.mark.parametrize("res", range(6))
def test_icosphere_tables_equal(res):
    """Same vertex and face order, same adjacency tables and row order;
    coordinates bit-equal (the same float64 operations in the same order)."""
    a, b = jico.icosphere(res), tico.icosphere(res)
    np.testing.assert_array_equal(b.coords, a.coords)
    for name in ("faces", "nbr_idx", "nbr_cnt", "tri_idx", "tri_cnt"):
        _equal_int(getattr(b, name), getattr(a, name))
    assert len(a.lineages) == len(b.lineages) == res
    for la, lb in zip(a.lineages, b.lineages):
        _equal_int(lb, la)
    if res:
        _equal_int(tico.face_lineage_across(0, res),
                   jico.face_lineage_across(0, res))
        assert (b.first_hexavalent_vertex() == a.first_hexavalent_vertex())


def _adjacency_loop(faces, nverts):
    """The per-face loop that `build_adjacency` replaces."""
    nbrs = [[] for _ in range(nverts)]
    tris = [[] for _ in range(nverts)]
    for t in range(faces.shape[0]):
        a, b, c = (int(x) for x in faces[t])
        for u, vs in ((a, (b, c)), (b, (a, c)), (c, (a, b))):
            tris[u].append(t)
            for v in vs:
                if v not in nbrs[u]:
                    nbrs[u].append(v)
    out = []
    for rows in (nbrs, tris):
        tab = np.full((nverts, max(len(x) for x in rows)), -1, np.int32)
        for i, r in enumerate(rows):
            tab[i, :len(r)] = r
        out += [tab, np.array([len(r) for r in rows], np.int32)]
    return tuple(out)


@pytest.mark.parametrize("case", ["ico3", "shuffled", "open"])
def test_build_adjacency_equals_loop(case):
    """Row order included, on a mesh that is not an icosphere in reference
    order: shuffled faces with rotated corners, and an open surface (a
    subset of faces, so some vertices have no face)."""
    ico = tico.icosphere(3)
    faces = ico.faces
    rng = np.random.default_rng(1)
    if case != "ico3":
        faces = faces[rng.permutation(len(faces))]
        roll = rng.integers(0, 3, len(faces))
        faces = np.stack([np.roll(f, r) for f, r in zip(faces, roll)])
    if case == "open":
        faces = faces[:400]
    got = tico.build_adjacency(faces, ico.nvertices)
    for g, w in zip(got, _adjacency_loop(faces, ico.nvertices)):
        _equal_int(g, w)


def test_mesh_methods_match():
    """Every Mesh method the port calls, on a warped ico-3 mesh with data:
    float64 numpy on both sides, the same formulas -> rtol 1e-12."""
    jm = warped_icosphere(3, seed=5, deg=4.0)
    jm.data = np.stack([smooth_pattern(jm.coords, 1),
                        smooth_pattern(jm.coords, 2)])
    tm = convert.mesh(jm)
    assert isinstance(tm, TMesh) and tm.coords is not jm.coords
    assert (tm.nvertices, tm.ntriangles, tm.dimension) == (
        jm.nvertices, jm.ntriangles, jm.dimension)
    assert tm.get_resolution() == jm.get_resolution() == 3
    for a, b in zip(tm.adjacency, jm.adjacency):
        _equal_int(a, b)
    for name in ("estimate_origin", "triangle_areas", "triangle_normals",
                 "vertex_normals", "vertex_area", "calculate_MaxVD",
                 "calculate_MeanVD", "max_vertex_distances"):
        np.testing.assert_allclose(getattr(tm, name)(), getattr(jm, name)(),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    # in-place geometry: recentre an off-centre copy, rescale, check_scale
    for m in (jm, tm):
        m.coords = m.coords * 1.07 + np.array([0.5, -0.25, 0.125])
    jm2, tm2 = jm.copy(), tm.copy()
    for m in (jm2, tm2):
        m.recentre()
        m.true_rescale(100.0)
    np.testing.assert_allclose(tm2.coords, jm2.coords, rtol=1e-12)
    jm.check_scale(jm2)
    tm.check_scale(tm2)
    np.testing.assert_allclose(tm.coords, jm.coords, rtol=1e-12)
    tm.set_data(jm.data.T)
    np.testing.assert_array_equal(tm.data, jm.data)
    f = JMesh.from_icosphere(2)
    g = TMesh.from_icosphere(2)
    np.testing.assert_array_equal(g.coords, f.coords)
    np.testing.assert_array_equal(g.data, f.data)


def test_create_exclusion_matches():
    jm = JMesh.from_icosphere(3)
    jm.data = np.stack([smooth_pattern(jm.coords, 3),
                        np.where(smooth_pattern(jm.coords, 4) > 0, 0.0, 1.0)])
    tm = convert.mesh(jm)
    for lo, hi in ((0.0, 0.0001), (-0.5, 0.5)):
        got = t_create_exclusion(tm, lo, hi)
        np.testing.assert_array_equal(got, j_create_exclusion(jm, lo, hi))
    assert 0 < got.sum() < got.size


@pytest.mark.parametrize("kind", ["surf.gii", "func.gii", "asc"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_io_round_trips_across_packages(tmp_path, kind, writer):
    """A file written by either package reads back the same in both:
    GIFTI stores float32 (exact equality of what was stored), FreeSurfer
    ASCII six decimals (atol 1e-6)."""
    jm = warped_icosphere(2, seed=7, deg=5.0)
    jm.data = np.stack([smooth_pattern(jm.coords, 1),
                        smooth_pattern(jm.coords, 2)])
    src = jm if writer == "jax" else convert.mesh(jm)
    path = str(tmp_path / f"m.{kind}")
    src.save(path)
    ja, ta = JMesh.load(path), TMesh.load(path)
    assert isinstance(ta, TMesh)
    np.testing.assert_array_equal(ta.coords, ja.coords)
    _equal_int(ta.faces, ja.faces)
    np.testing.assert_array_equal(ta.data, ja.data)
    if kind == "func.gii":
        want = jm.data.astype(np.float32).astype(np.float64)
        np.testing.assert_array_equal(ta.data, want)
        np.testing.assert_array_equal(tio.load_data(path, src),
                                      jio.load_data(path, jm))
    else:
        tol = 0 if kind == "surf.gii" else 1e-6
        want = (jm.coords.astype(np.float32).astype(np.float64)
                if kind == "surf.gii" else jm.coords)
        np.testing.assert_allclose(ta.coords, want, atol=tol, rtol=0)
        _equal_int(ta.faces, jm.faces)
    if kind == "asc":
        np.testing.assert_allclose(tio.load_data(path, src)[0], jm.data[0],
                                   atol=1e-6, rtol=0)


def _strain_config_text():
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module("chip_smoke").STRAIN_CONFIG
    finally:
        sys.path.remove(str(ROOT))


@pytest.mark.parametrize("which", ["strain", "typical", "default"])
def test_parse_config_matches(tmp_path, which):
    text = {"strain": _strain_config_text, "typical": lambda:
            TYPICAL_CONFIG_TEXT, "default": lambda: None}[which]()
    path = None
    if text is not None:
        path = str(tmp_path / "conf")
        pathlib.Path(path).write_text(text)
    got = dataclasses.asdict(tconfig.parse_config(path))
    assert got == dataclasses.asdict(jconfig.parse_config(path))
    if which == "typical":
        assert got == dataclasses.asdict(typical_config())
    if which == "strain":
        assert got["cost"] == ["AFFINE", "DISCRETE", "DISCRETE", "DISCRETE"]
        assert got["datagrid"] == [5, 5, 5, 6] and got["regmode"] == 3
    for name in ("_LIST_FLAGS", "_SCALAR_FLAGS", "_BOOL_FLAGS"):
        assert getattr(tconfig, name) == getattr(jconfig, name)


def test_parse_config_rejects_like_the_original(tmp_path):
    path = tmp_path / "conf"
    for text in ("--opt=DISCRETE\n--dopt=HOCR\n--regoption=4\n", "--nonsense\n",
                 "--opt=DISCRETE,DISCRETE\n--it=3\n"):
        path.write_text(text)
        for mod in (tconfig, jconfig):
            with pytest.raises(ValueError):
                mod.parse_config(str(path))


@pytest.mark.parametrize("sg_res,dist", [(2, 31.4), (3, 31.4), (4, 16.3)])
def test_sampling_grid_matches(sg_res, dist):
    """The same float64 BFS on equal tables: bit-equal label sets (the
    distances are half the ico-1 and ico-2 control-point spacings, as the
    model sets them)."""
    a = jsg.build_sampling_grid(sg_res, dist)
    b = tsg.build_sampling_grid(sg_res, dist)
    for name in ("centre", "samples", "barycentres"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
    assert len(b.samples) > 1 and len(b.barycentres) > 1
    for scale in (1.0, 0.64):
        np.testing.assert_array_equal(
            tsg.rescale_labels(b, b.samples, scale),
            jsg.rescale_labels(a, a.samples, scale))


@pytest.mark.parametrize("res", [0, 2, 3])
def test_vertex_colouring_and_groups_match(res):
    faces = tico.icosphere(res).faces
    n = tico.icosphere(res).nvertices
    cj = jcol.vertex_coloring_from_faces(faces, n)
    ct = tcol.vertex_coloring_from_faces(faces, n)
    _equal_int(ct, cj)
    for a, b in zip(tcol.color_groups(ct), jcol.color_groups(cj)):
        _equal_int(a, b)
    # a colouring: no face holds two vertices of one colour
    assert (np.sort(ct[faces], axis=1)[:, 1:]
            != np.sort(ct[faces], axis=1)[:, :-1]).all()


def test_synth_cohort_matches():
    """synth_cohort(3, 2, seed=0): the same generators and float64
    formulas -> bit-equal meshes and data."""
    mj, dj, tj = jsynth.synth_cohort(3, 2, seed=0)
    mt, dt, tt = tsynth.synth_cohort(3, 2, seed=0)
    np.testing.assert_array_equal(tt, tj)
    assert len(mt) == len(mj) == 2
    for a, b, x, y in zip(mt, mj, dt, dj):
        assert isinstance(a, TMesh)
        np.testing.assert_array_equal(a.coords, b.coords)
        _equal_int(a.faces, b.faces)
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        tsynth.smooth_sphere_warp(mt[0].coords / 100.0, 3, 4.0),
        jsynth.smooth_sphere_warp(mj[0].coords / 100.0, 3, 4.0))


# ------------------------------------------ table code against its loops

def _pad_rows(rows, pads):
    out = np.empty((len(rows), max(len(r) for r in rows)), np.int32)
    for v, (r, p) in enumerate(zip(rows, pads)):
        out[v, :len(r)] = r
        out[v, len(r):] = p
    return out


def _ring_faces_loop(nbr_idx, tri_idx):
    rows = []
    for v in range(nbr_idx.shape[0]):
        fs = [int(t) for t in tri_idx[v] if t >= 0]
        seen = set(fs)
        for a in nbr_idx[v]:
            if a < 0:
                continue
            for t in tri_idx[a]:
                if t >= 0 and int(t) not in seen:
                    seen.add(int(t))
                    fs.append(int(t))
        rows.append(fs)
    return _pad_rows(rows, [r[0] for r in rows])


def _bfs_ball_loop(nbr, n_centres, depth):
    rows = []
    for v in range(n_centres):
        seen = {v}
        frontier = [v]
        for _ in range(depth):
            nxt = []
            for a in frontier:
                for b in nbr[a]:
                    if b >= 0 and int(b) not in seen:
                        seen.add(int(b))
                        nxt.append(int(b))
            frontier = nxt
        rows.append(sorted(seen))
    return _pad_rows(rows, range(n_centres))


@pytest.mark.parametrize("case", ["ico2", "ico4", "shuffled"])
def test_ring_faces_equal_loop(case):
    """First-seen order included (the containment choice breaks ties by
    position)."""
    if case == "shuffled":
        ico = tico.icosphere(3)
        faces = ico.faces[np.random.default_rng(2).permutation(ico.ntriangles)]
        nbr, _, tri, _ = tico.build_adjacency(faces, ico.nvertices)
    else:
        ico = tico.icosphere(int(case[-1]))
        nbr, tri = ico.nbr_idx, ico.tri_idx
    _equal_int(tnst._build_ring_faces(nbr, tri), _ring_faces_loop(nbr, tri))


@pytest.mark.parametrize("depth", [3, 4, 8])
@pytest.mark.parametrize("res", [3, 4])
def test_bfs_ball_equals_loop(res, depth):
    nbr = tico.icosphere(res).nbr_idx
    n_centres = tico.icosphere(res - 1).nvertices
    _equal_int(tnst._bfs_ball(nbr, n_centres, depth),
               _bfs_ball_loop(nbr, n_centres, depth))


def _ball_cover_dense(res, n_centres, depth):
    """The host search `_ball_cover` replaces: dense float64 arcs from each
    centre to ALL vertices, ball members masked, the minimum."""
    tab = TC._ball_table_np(res, n_centres, depth)
    u = tico.icosphere(res).coords
    cover = np.inf
    for s in range(0, n_centres, 256):
        e = min(s + 256, n_centres)
        dist = 100.0 * np.arccos(np.clip(u[s:e] @ u.T, -1.0, 1.0))
        t = tab[s:e]
        rr, cc = np.nonzero(t >= 0)
        dist[rr, t[rr, cc]] = np.inf
        cover = min(cover, float(dist.min()))
    return cover


@pytest.mark.parametrize("res,cp_res", [(3, 1), (4, 2), (5, 3)])
def test_ball_cover_equals_dense_search(res, cp_res):
    """Every depth of `patch_candidate_ball`'s loop: the masked maximum of
    the dot products with one arccos at the end agrees with the arccos of
    every entry to 1e-9 relative (a float64 product's last bits), and with
    the JAX package's value; inf once the ball holds every vertex."""
    k = tico.icosphere(cp_res).nvertices
    for depth in TC.BALL_DEPTHS:
        got = TC._ball_cover(res, k, depth, CPU)
        want = _ball_cover_dense(res, k, depth)
        assert want == JC._ball_cover_np(res, k, depth)
        if np.isinf(want):
            assert np.isinf(got)
        else:
            assert got == pytest.approx(want, rel=1e-9)
        _equal_int(TC._ball_table_np(res, k, depth),
                   JC._ball_table_np(res, k, depth))


@pytest.mark.parametrize("cp_res,src_res", [(1, 3), (2, 4), (3, 4)])
def test_max_inrange_count_equals_host_count(cp_res, src_res):
    control = JMesh.from_icosphere(cp_res)
    source = warped_icosphere(src_res, seed=2, deg=2.0)
    lim = control.max_vertex_distances()
    want = JC.max_inrange_count(control.coords, source.coords, lim)
    assert TC.max_inrange_count(control.coords, source.coords, lim,
                                device="cpu") == want
    assert TC.max_inrange_count(control.coords, source.coords, lim,
                                chunk=7, device="cpu") == want


@pytest.mark.parametrize("deg,limit_scale", [(1.0, 1.0), (3.0, 1.0),
                                             (1.0, 3.0), (30.0, 1.0)])
def test_patch_candidate_ball_end_to_end(deg, limit_scale):
    """A warped ico-4 source under ico-2 control points: the same table (or
    the same refusal) as the JAX package's, across mild warps, a wide
    limit (deeper ball) and a warp too strong to certify."""
    control = JMesh.from_icosphere(2)
    source = warped_icosphere(4, seed=2, deg=deg)
    cp = control.coords.astype(np.float32)
    src = source.coords.astype(np.float32)
    lim = (limit_scale * control.max_vertex_distances()).astype(np.float32)
    want = JC.patch_candidate_ball(cp, src, source.faces, lim)
    got = TC.patch_candidate_ball(cp, src, source.faces, lim, device="cpu")
    assert (got is None) == (want is None)
    if (deg, limit_scale) == (1.0, 1.0):
        assert want is not None
    if deg == 30.0:
        assert want is None
    if want is not None:
        _equal_int(got, want)
    # not an icosphere in reference order -> no ball, as in the original
    assert TC.patch_candidate_ball(cp, src, source.faces[::-1], lim,
                                   device="cpu") is None


def test_device_defaults_to_cuda_and_never_falls_back():
    """Every public function that takes `device` resolves None to cuda and
    raises without a card; "cpu" is used only when asked for."""
    from newmsm_tpu_torch import resolve_device
    from newmsm_tpu_torch.ops import resample as trsp
    from newmsm_tpu_torch.ops import unfold as tunf
    from newmsm_tpu_torch.reg import featurespace as tfeat
    from newmsm_tpu_torch.reg import model as tmodel
    from newmsm_tpu_torch.reg import rigid as trigid
    from newmsm_tpu_torch.reg.driver import MeshRegistration
    from newmsm_tpu_torch.reg.optimise import fusion as tfusion
    import inspect
    fns = [tfeat.initialise, trigid.rigid_align, tmodel.PairwiseModel.__init__,
           tnst.build_tables, trsp.metric_resample, trsp.smooth_data,
           trsp.nearest_neighbour_interpolation, trsp.sphere_project_warp,
           tunf.unfold, tunf.count_folds, tfusion.build_fusion_tables,
           TC.patch_candidate_ball, TC.max_inrange_count,
           MeshRegistration.__init__, convert.tensor, convert.search_tables,
           convert.level_tables, convert.fusion_tables,
           convert.iteration_state, resolve_device]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default is None, fn
    assert resolve_device("cpu") == CPU
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    mesh = TMesh.from_icosphere(2)
    calls = [lambda: resolve_device(None), lambda: MeshRegistration(),
             lambda: tunf.count_folds(mesh), lambda: tunf.unfold(mesh),
             lambda: tnst.build_tables(mesh.coords, mesh.faces),
             lambda: trsp.sphere_project_warp(mesh, mesh, mesh),
             lambda: trsp.smooth_data(mesh, 2.0),
             lambda: tfusion.build_fusion_tables(mesh.faces, mesh.nvertices),
             lambda: TC.max_inrange_count(mesh.coords, mesh.coords,
                                          np.ones(mesh.nvertices)),
             lambda: convert.tensor(np.zeros(3))]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# --------------------------------------------- cohort bookkeeping and reports

def _toy_cohort_files(d):
    """Groups A(12) B(11) C(3) D(10) under (A,B)->N1, (C,D)->N2,
    (N1,N2)->ROOT, as the two CSV files the reference scripts read."""
    groups = {"A": [f"a{i}" for i in range(12)],
              "B": [f"b{i}" for i in range(11)],
              "C": [f"c{i}" for i in range(3)],
              "D": [f"d{i}" for i in range(10)]}
    hierarchy = [("A", "B", "N1"), ("C", "D", "N2"), ("N1", "N2", "ROOT")]
    with open(d / "clusters.csv", "w") as f:
        n = 0
        for g, subs in groups.items():
            for s in subs:
                f.write(f"{n},{s},{g}\n")
                n += 1
    with open(d / "hier.csv", "w") as f:
        for row in hierarchy:
            f.write(",".join(row) + "\n")
    return str(d / "clusters.csv"), str(d / "hier.csv")


@pytest.mark.parametrize("min_size", [10, 3, 11])
def test_cohort_bookkeeping_matches(tmp_path, min_size):
    """pipelines.cohort (host-only): the CSV readers, extract_info, the
    study files and gen_order give the JAX package's results, field by
    field and byte by byte."""
    from newmsm_tpu.pipelines import cohort as jc
    from newmsm_tpu_torch.pipelines import cohort as tc
    cl, hi = _toy_cohort_files(tmp_path)
    assert tc.read_clustering(cl) == jc.read_clustering(cl)
    assert tc.read_hierarchy(hi) == jc.read_hierarchy(hi)
    js = jc.extract_info(cl, hi, "ROOT", min_size=min_size)
    ts = tc.extract_info(cl, hi, "ROOT", min_size=min_size)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert list(ts.groups) == list(js.groups)          # order too
    jc.write_study_files(js, str(tmp_path / "j"))
    tc.write_study_files(ts, str(tmp_path / "t"))
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) == 3
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    assert tc.gen_order(ts.groups, ts.tree) == jc.gen_order(js.groups, js.tree)
    assert tc.gen_order(ts.groups, list(reversed(ts.tree))) == \
        jc.gen_order(js.groups, list(reversed(js.tree)))


def test_cohort_bookkeeping_rejects_like_the_original(tmp_path):
    from newmsm_tpu_torch.pipelines import cohort as tc
    cl, hi = _toy_cohort_files(tmp_path)
    with pytest.raises(ValueError, match="min_size"):
        tc.extract_info(cl, hi, "ROOT", min_size=100)
    st = tc.extract_info(cl, hi, "ROOT", min_size=10)
    with pytest.raises(ValueError, match="unknown group"):
        tc.gen_order(st.groups, [("A", "NOPE", "N1")])
    # a chain-like dendrogram far past the recursion limit
    hierarchy = [("A", "B", "n0")] + [(f"n{i}", f"leaf{i}", f"n{i + 1}")
                                      for i in range(5000)]
    deep = tc.extract_info(st.groups, hierarchy, "n5000", min_size=10)
    assert deep.tree == [("A", "B", "n0")]


def test_reports_match(tmp_path):
    """eval.reports (host-only): the CSV bytes, the table read back, and a
    distortion chart."""
    from newmsm_tpu.eval import reports as jr
    from newmsm_tpu_torch.eval import reports as tr
    assert tr.STAT_COLUMNS == jr.STAT_COLUMNS
    stats = {"A": {"cc": 0.8, "dice": 0.6, "areal_mean": 0.2,
                   "areal_max": 1.0, "areal_95": 0.5, "areal_98": 0.6,
                   "shape_mean": 0.4, "shape_max": 1.5},
             "B": {"cc": 0.7, "dice": 0.5, "areal_mean": 0.3}}
    jr.group_stats_csv(stats, str(tmp_path / "j.csv"))
    tr.group_stats_csv(stats, str(tmp_path / "t.csv"))
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    back = tr.read_group_stats_csv(str(tmp_path / "t.csv"))
    assert back == jr.read_group_stats_csv(str(tmp_path / "j.csv"))
    assert back["A"]["cc"] == pytest.approx(0.8) and "dice" in back["B"]
    assert "shape_max" not in back["B"]
    rng = np.random.default_rng(0)
    tr.plot_distortions({"A": [rng.normal(size=100)],
                         "B": [rng.normal(size=100)]},
                        str(tmp_path / "dist.png"))
    assert (tmp_path / "dist.png").stat().st_size > 1000
