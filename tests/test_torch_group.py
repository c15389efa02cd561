"""The groupwise path of newmsm_tpu_torch against the JAX package, on the
CPU: host tables, label maps, partner map, one alpha step's binary tables,
the group fusion sweep, the pmax regrow, the apply stage, the whole driver
and both CLIs. The JAX side runs on a 1-device `subjects` mesh, as
tests/test_group_sharded.py does.

The JAX fusion program keeps its binary tables inside one jitted closure;
`jax_fusion_run` reads them out with a `jax.debug.callback` placed on its
`_binary_icm`, one (t8, p4) pair per alpha step.

Ties. On pristine grids (every first iteration: data grid, CP grids and
sampling-grid labels are all icosphere vertices) template vertices land
exactly on edges and vertices of the label-displaced data grid. XLA and
torch decide ~2 % of those face ties differently, and a tie changes how
many reverse-map entries a template vertex counts, so `adaptive_weights`
switches between its forward and reverse map there: the label maps then
differ at those vertices by the data's own contrast. Module tests
therefore compare from injected, slightly warped state, and the whole
driver is held tightly on a template rotated off the data grid and loosely
on the pristine template.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from newmsm_tpu.core.mesh import Mesh
from newmsm_tpu.ops import nearest as jnst
from newmsm_tpu.ops import resample as jrsp
from newmsm_tpu.parallel import group_fusion as JGF
from newmsm_tpu.reg.group import GroupMeshRegistration as JGroup
from newmsm_tpu.reg.optimise import fusion as JFU
from newmsm_tpu.reg.sampling_grid import build_sampling_grid

from newmsm_tpu_torch import convert
from newmsm_tpu_torch.core.mesh import Mesh as TMesh
from newmsm_tpu_torch.ops import nearest as tnst
from newmsm_tpu_torch.ops import resample as trsp
from newmsm_tpu_torch.ops.unfold import count_folds as tfolds
from newmsm_tpu_torch.parallel import group_fusion as TGF
from newmsm_tpu_torch.reg.config import RegConfig as TRegConfig
from newmsm_tpu_torch.reg.group import GroupMeshRegistration as TGroup

from fixtures import rotation_matrix
from test_group import group_config, make_group, mean_pairwise_corr
from torch_helpers import np_, warped_icosphere


def T(a):
    return convert.tensor(a, "cpu")


def one_device_mesh():
    return JMesh(np.array(jax.devices()[:1]), ("subjects",))


def jax_group_starts(N, n_restarts=2):
    """The JAX group optimiser's random starts (group_fusion.py:657-659),
    for injection into the port."""
    def starts(alpha):
        key = jax.random.fold_in(jax.random.PRNGKey(7), alpha)
        return torch.from_numpy(np.array(jax.random.bernoulli(
            key, 0.5, (n_restarts, N)).astype(jnp.int32)))
    return starts


# ------------------------------------------------------------- host tables

def _partner_case(which, S, K, seed=0):
    if which == "converged":           # every CP pairs with its own index
        return np.broadcast_to(np.arange(K, dtype=np.int32), (S, S, K)).copy()
    return np.random.default_rng(seed).integers(
        0, K, size=(S, S, K)).astype(np.int32)


@pytest.mark.parametrize("S", [2, 3, 5])
def test_pair_blocks_equal(S):
    np.testing.assert_array_equal(TGF.pair_blocks(S), JGF.pair_blocks(S))


@pytest.mark.parametrize("res", [0, 1, 2])
def test_triplet_incidence_equal(res):
    m = Mesh.from_icosphere(res)
    trip = np.sort(m.faces.astype(np.int32), axis=1)
    for a, b in zip(TGF._triplet_incidence(trip, m.nvertices),
                    JGF._triplet_incidence(trip, m.nvertices)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["random", "converged"])
def test_iteration_tables_and_colouring_equal(which):
    """Integer tables equal the JAX package's once its bucket padding is
    dropped (convert.group_iter_tables), and the first-fit colouring is the
    same node by node."""
    S = 3
    m = Mesh.from_icosphere(1)
    K = m.nvertices
    trip = np.sort(m.faces.astype(np.int32), axis=1)
    partner = _partner_case(which, S, K)
    want = convert.group_iter_tables(
        JGF.build_iteration_tables(partner, trip, S, K), "cpu")
    got = TGF.build_iteration_tables(partner, trip, S, K, "cpu")
    np.testing.assert_array_equal(got.colors, want.colors)
    assert len(got.groups) == len(want.groups)
    for g, w in zip(got.groups, want.groups):
        np.testing.assert_array_equal(np_(g), np_(w))
    for name in ("vert_tri", "vert_tri_corner", "vert_pair", "vert_pair_end"):
        np.testing.assert_array_equal(np_(getattr(got, name)),
                                      np_(getattr(want, name)), err_msg=name)
    # a proper colouring: no triplet or pair edge inside one colour
    c = got.colors
    full = np.concatenate([trip + s * K for s in range(S)])
    assert (c[full[:, 0]] != c[full[:, 1]]).all()
    assert (c[full[:, 1]] != c[full[:, 2]]).all()
    assert (c[full[:, 0]] != c[full[:, 2]]).all()
    # memo: the same partner map gives the same object back
    assert TGF.build_iteration_tables(partner, trip, S, K, "cpu") is got


@pytest.mark.parametrize("which", ["random", "converged"])
def test_greedy_color_equals_the_python_loop_contract(which):
    S, K = 3, 42
    m = Mesh.from_icosphere(1)
    trip = np.sort(m.faces.astype(np.int32), axis=1)
    partner = _partner_case(which, S, K, seed=4)
    blocks = JGF.pair_blocks(S)
    e0 = (blocks[:, 0][:, None] * K + np.arange(K)[None]).ravel()
    e1 = (blocks[:, 1][:, None] * K
          + partner[blocks[:, 0], blocks[:, 1]]).ravel()
    full = np.concatenate([trip + s * K for s in range(S)])
    src = np.concatenate([full[:, 0], full[:, 0], full[:, 1], full[:, 1],
                          full[:, 2], full[:, 2], e0, e1])
    dst = np.concatenate([full[:, 1], full[:, 2], full[:, 0], full[:, 2],
                          full[:, 0], full[:, 1], e1, e0])
    order = np.argsort(src, kind="stable")
    np.testing.assert_array_equal(
        TGF._greedy_color(src[order], dst[order], S * K),
        JGF._greedy_color(src[order], dst[order], S * K))


# --------------------------------------------------------------- label maps

def test_vertex_areas_kernel_matches():
    """rtol 1e-5."""
    m = warped_icosphere(3, seed=2, deg=5.0)
    tri_idx = m.adjacency[2]
    want = jrsp.vertex_areas_kernel(jnp.asarray(m.coords, jnp.float32),
                                    jnp.asarray(m.faces), jnp.asarray(tri_idx))
    got = trsp.vertex_areas_kernel(T(m.coords), T(m.faces), T(tri_idx))
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-5)
    np.testing.assert_allclose(np_(got), m.vertex_area(), rtol=1e-4)


def _label_grid(cp_res=1, sg_res=3):
    control = Mesh.from_icosphere(cp_res)
    control.true_rescale(100.0)
    sg = build_sampling_grid(sg_res, 0.5 * control.calculate_MaxVD())
    return (control, np.asarray(sg.samples, np.float32),
            np.asarray(sg.centre, np.float32))


def test_label_deformed_maps_matches_on_a_warped_grid():
    """(L,D,Nt) maps of a warped ico-3 data grid with D = 2 random-normal
    channels (the hardest data: no smoothness hides a wrong vertex), onto
    the pristine ico-3 template, through the locate twin on both sides.
    atol 1e-4 on all but at most 1e-3 of the entries, which stay within
    1e-3: a template vertex within float32 rounding of a data-grid edge
    takes its third, ~0-weight vertex from either face."""
    dg = warped_icosphere(3, seed=3, deg=4.0)
    tm = Mesh.from_icosphere(3)
    tm.true_rescale(100.0)
    _, labels, centre = _label_grid()
    data = np.random.default_rng(0).normal(
        size=(2, dg.nvertices)).astype(np.float32)
    tri_idx = dg.adjacency[2]
    jtab = jnst.build_tables(dg.coords, dg.faces, tri_idx)
    cap = jrsp._adaptive_cap(dg.nvertices, tm.nvertices)
    want = np_(jrsp.label_deformed_maps(
        jnp.asarray(dg.coords, jnp.float32), jnp.asarray(data), jtab.faces,
        jnp.asarray(tri_idx), jtab.ring_faces, jtab.ring_verts,
        jnp.asarray(labels), jnp.asarray(centre),
        jnst.build_tables(tm.coords, tm.faces, tm.adjacency[2]),
        jnp.asarray(tm.vertex_area(), jnp.float32), cap=cap))
    ttm = tnst.build_tables(tm.coords, tm.faces, tm.adjacency[2], "cpu")
    assert ttm.pristine_res == 3
    got = np_(trsp.label_deformed_maps(
        T(dg.coords), T(data), T(jtab.faces), T(tri_idx), T(jtab.ring_faces),
        T(jtab.ring_verts), T(labels), T(centre), ttm, T(tm.vertex_area()),
        cap=cap))
    assert got.shape == want.shape == (len(labels), 2, tm.nvertices)
    err = np.abs(got - want)
    assert err.max() < 1e-3, err.max()
    assert (err > 1e-4).mean() <= 1e-3, (err > 1e-4).sum()


@pytest.fixture
def one_thread():
    """One CPU thread: above its grain size the CPU's
    index_put_(accumulate=True) sums duplicates in an order that follows
    the thread count (its CUDA version sorts, stably, whatever the size),
    so a batched call is compared with per-label calls at one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _warped_level(res):
    """A warped ico-`res` data grid (numpy Mesh of the port), its tables and
    2 random-normal channels, and a pristine template one level coarser
    (no face ties; cap > 16, so rows take the reverse map too) on the CPU."""
    dg = TMesh.from_icosphere(res)
    dg.coords = np.asarray(warped_icosphere(res, seed=3, deg=4.0).coords)
    tm = TMesh.from_icosphere(res - 1)
    tm.true_rescale(100.0)
    data = np.random.default_rng(0).normal(
        size=(2, dg.nvertices)).astype(np.float32)
    return (dg, tnst.build_tables(dg.coords, dg.faces, dg.adjacency[2], "cpu"),
            tm, tnst.build_tables(tm.coords, tm.faces, tm.adjacency[2], "cpu"),
            data)


@pytest.mark.parametrize("res", [3, 4])
@pytest.mark.parametrize("L", [1, 7, 19])
def test_batched_label_maps_are_the_single_label_calls(one_thread, res, L):
    """label_deformed_maps of L labels at once (the twin route: one
    labelmap.twin call, one reverse map, one adaptive_combine) equals bit
    for bit the stack of its L single-label calls."""
    dg, tabs, tm, ttm, data = _warped_level(res)
    _, labels, centre = _label_grid()
    labels = labels[:L]
    assert len(labels) == L
    args = (T(dg.coords), T(data), tabs.faces,
            torch.as_tensor(dg.adjacency[2].astype(np.int64)),
            tabs.ring_faces, tabs.ring_verts)
    rest = (T(centre), ttm, T(tm.vertex_area()))
    cap = trsp._adaptive_cap(dg.nvertices, tm.nvertices)
    got = trsp.label_deformed_maps(*args, T(labels), *rest, cap=cap)
    want = torch.stack([trsp.label_deformed_maps(
        *args, T(labels[l:l + 1]), *rest, cap=cap)[0] for l in range(L)])
    assert got.shape == (L, 2, tm.nvertices)
    assert torch.equal(got, want)


def test_adaptive_weights_on_a_label_axis_are_its_per_label_calls(
        one_thread):
    """adaptive_combine over 5 label-deformed ico-4 grids at once, with an
    exclusion gate, equals bit for bit adaptive_weights a grid at a time
    (its forward and reverse maps, gate and combination on a label axis of
    one)."""
    from newmsm_tpu_torch.ops.labelmap import deformed_grids
    dg, tabs, tm, ttm, _ = _warped_level(4)
    _, labels, centre = _label_grid()
    grids = deformed_grids(T(dg.coords), T(labels[::4]), T(centre))
    excl = T(np.random.default_rng(1).random(dg.nvertices) > 0.2)
    low, low_va = ttm.coords, T(tm.vertex_area())
    tri_idx = torch.as_tensor(dg.adjacency[2].astype(np.int64))
    in_va = trsp.vertex_areas_kernel(grids, tabs.faces, tri_idx)
    cap = trsp._adaptive_cap(dg.nvertices, tm.nvertices)
    per, fwd, rev, gate = [], [], [], []
    for g, va in zip(grids, in_va):
        t = tnst.SearchTables(coords=g, faces=tabs.faces,
                              ring_faces=tabs.ring_faces,
                              ring_verts=tabs.ring_verts)
        per.append(trsp.adaptive_weights(g, low, t, ttm, va, low_va, excl,
                                         cap=cap))
        fwd.append(tnst.barycentric_coords(low, t))
        rev.append(tnst.barycentric_coords(g, ttm))
        gate.append(excl[tnst.closest_vertex(low, t)] != 0)
    idx, w = trsp.adaptive_combine(
        *(torch.stack(x) for x in zip(*fwd)),
        *(torch.stack(x) for x in zip(*rev)), in_va, low_va,
        torch.stack(gate), cap=cap)
    assert not torch.stack(gate).all()
    assert torch.equal(idx, torch.stack([i for i, _ in per]))
    assert torch.equal(w, torch.stack([x for _, x in per]))


def test_traced_group_run_counts_one_labelmap_call_a_subject_a_maps_span(
        tmp_path):
    """A traced 3-subject ico-3 group run on the CPU: every `group.maps`
    span counts one labelmap.twin call a subject (one rank owns all three)
    and no labelmap.kernel, with labelmap.labels L a call and
    labelmap.queries L x Nt."""
    meshes, datasets = make_group(3)
    template = rotated_template()
    g = TGroup(device="cpu")
    g.set_inputs([convert.mesh(m) for m in meshes])
    g.set_data_list([d.copy() for d in datasets])
    g.set_template(convert.mesh(template))
    g.outdir = str(tmp_path / "t_")
    g.metrics_path = g.outdir + "metrics.jsonl"
    g.run_multiresolutions(torch_config(group_config(iters=2)))
    spans = [e for e in map(json.loads, open(g.metrics_path))
             if e["event"] == "span" and e["name"] == "group.maps"]
    L = len(_label_grid()[1])
    assert len(spans) == 2
    for s in spans:
        c = s["counters"]
        assert c["labelmap.twin"] == 3 and "labelmap.kernel" not in c, c
        assert c["labelmap.labels"] == 3 * L, c
        assert c["labelmap.queries"] == 3 * L * template.nvertices, c


# ------------------------------------------------------------ group problem

def build_problem(S, seed=0, D=2, simval=2, masked=False, cprange=1.0):
    """A level's statics in both packages, and warped state: CP ico-1,
    template ico-3, every CP grid jittered (no pristine ties)."""
    control, labels, centre = _label_grid()
    template = Mesh.from_icosphere(3)
    template.true_rescale(100.0)
    K, Nt = control.nvertices, template.nvertices
    trip = np.sort(control.faces.astype(np.int32), axis=1)
    rng = np.random.default_rng(seed)
    mask_w = (np.abs(rng.normal(size=Nt)).astype(np.float32)
              if masked else None)
    st = JGF.GroupLevelStatics(
        labels=jnp.asarray(labels), centre=jnp.asarray(centre),
        orig_cp=jnp.asarray(control.coords, jnp.float32),
        cp_faces=jnp.asarray(trip),
        tmpl_coords=jnp.asarray(template.coords, jnp.float32),
        mask_w=None if mask_w is None else jnp.asarray(mask_w),
        cp_search=jnst.build_tables(control.coords, control.faces,
                                    control.adjacency[2]),
        mu=0.4, kappa=1.6, k_exp=2.0, rexp=2.0, reglambda=0.1,
        subcorr=0.1 * S, simval=simval, percentile=0.75, pmax=128,
        cprange=cprange, fixnan=False)
    cp = np.broadcast_to(np.asarray(control.coords, np.float32),
                         (S, K, 3)).copy()
    cp += rng.normal(size=cp.shape).astype(np.float32) * 1.5
    cp /= np.linalg.norm(cp, axis=-1, keepdims=True) / 100.0
    spac = np.broadcast_to(np.asarray(control.max_vertex_distances(),
                                      np.float32), (S, K)).copy()
    maps = rng.normal(size=(S, len(labels), D, Nt)).astype(np.float32)
    return dict(st=st, tst=convert.group_statics(st, "cpu"), trip=trip,
                maps=maps, cp=cp, spac=spac, S=S, K=K, L=len(labels),
                control=control, template=template)


def test_group_statics_conversion_carries_every_field():
    p = build_problem(2, masked=True)
    st, tst = p["st"], p["tst"]
    for name in ("labels", "centre", "orig_cp", "cp_faces", "tmpl_coords",
                 "mask_w"):
        np.testing.assert_array_equal(np_(getattr(tst, name)),
                                      np_(getattr(st, name)))
    for name in ("mu", "kappa", "k_exp", "rexp", "reglambda", "subcorr",
                 "simval", "percentile", "pmax", "cprange", "fixnan",
                 "sweeps", "icm_passes", "n_restarts"):
        assert getattr(tst, name) == getattr(st, name), name
    assert tst.cp_search.pristine_res == st.cp_search.pristine_res
    assert tst.cp_faces.dtype == torch.int64


def jax_partner(p):
    return np.asarray(JGF.make_partner_fn(one_device_mesh(), p["st"], p["S"])(
        jnp.asarray(p["cp"])))


@pytest.mark.parametrize("strong", [False, True],
                         ids=["warped", "strongly_deformed"])
def test_partner_map_equal(strong):
    """Equal (S,S,K) partner maps on warped CP grids; under a deformation
    big enough to change the Voronoi assignment the answer must come from
    the DEFORMED grids (as tests/test_group_sharded.py:189)."""
    S = 2 if strong else 3
    p = build_problem(S, seed=7 if strong else 3)
    if strong:
        rng = np.random.default_rng(11)
        cp = np.broadcast_to(np.asarray(p["control"].coords, np.float32),
                             (S, p["K"], 3)).copy()
        cp += rng.normal(size=cp.shape).astype(np.float32) * 25.0
        cp /= np.linalg.norm(cp, axis=-1, keepdims=True) / 100.0
        p["cp"] = cp
    want = jax_partner(p)
    got = np_(TGF.make_partner_fn(p["tst"], S)(T(p["cp"])))
    assert got.shape == (S, S, p["K"])
    np.testing.assert_array_equal(got, want)
    if strong:
        # and it differs from the answer on the pristine geometry
        pristine = np.broadcast_to(np.arange(p["K"]), (S, S, p["K"]))
        assert (got != pristine).any()
        control = convert.mesh(p["control"])
        for a in range(S):
            for b in range(S):
                tabs = tnst.build_tables(p["cp"][b], control.faces,
                                         control.adjacency[2], "cpu")
                tabs = dataclasses.replace(tabs, pristine_res=-1, descent=())
                ref = np_(tnst.closest_vertex(T(p["cp"][a]), tabs))
                np.testing.assert_array_equal(got[a, b], ref)


def test_partner_on_identical_grids_is_the_identity():
    """On identical (pristine) grids one vertex of the found face is at
    distance exactly 0, so the first-minimum rule is safe: partner[a,b,v]
    == v."""
    p = build_problem(3)
    K = p["K"]
    cp = np.broadcast_to(np.asarray(p["control"].coords, np.float32),
                         (3, K, 3)).copy()
    got = np_(TGF.make_partner_fn(p["tst"], 3)(T(cp)))
    np.testing.assert_array_equal(got, np.broadcast_to(np.arange(K),
                                                       (3, 3, K)))


# ------------------------------------------- one alpha step and the sweep

def jax_fusion_run(p, lab0=None, sweeps=1):
    """The JAX fusion sweep on problem p from labeling lab0, host alpha
    loop; returns (labeling, energy, patch_need, [(t8, p4) per alpha step],
    partner, tables)."""
    S, K = p["S"], p["K"]
    st = p["st"]._replace(sweeps=sweeps)
    partner = jax_partner(p)
    tables = JGF.build_iteration_tables(partner, p["trip"], S, K)
    captured = []
    orig = JFU._binary_icm

    def spy(x, u0, u1, t8, p4, trip, pairs, ft, passes):
        jax.debug.callback(
            lambda a, b: captured.append((np.array(a), np.array(b))), t8, p4)
        return orig(x, u0, u1, t8, p4, trip, pairs, ft, passes)

    JFU._binary_icm = spy
    try:
        fn = JGF.make_fusion_fn(one_device_mesh(), st, S, alpha_loop="host")
        lab0 = (jnp.zeros((S * K,), jnp.int32) if lab0 is None
                else jnp.asarray(lab0, jnp.int32))
        lab, energy, need = fn(jnp.asarray(p["maps"]), jnp.asarray(p["cp"]),
                               jnp.asarray(p["spac"]), lab0,
                               jnp.asarray(partner), tables)
        lab = np.asarray(lab)
        jax.effects_barrier()
    finally:
        JFU._binary_icm = orig
    return lab, float(energy), int(need), captured, partner, tables


VARIANTS = {
    "corr": dict(simval=2, masked=False),
    "corr_masked": dict(simval=2, masked=True),
    "ssd": dict(simval=1, masked=False),
}


@functools.lru_cache(maxsize=None)
def run_sweep(variant):
    """One sweep (19 alpha steps) from a random labeling in both packages,
    the port with the JAX package's random starts. Kept for the module:
    each JAX fusion program is a compile."""
    kw = VARIANTS[variant]
    S = 3
    p = build_problem(S, seed=5, **kw)
    K, L = p["K"], p["L"]
    lab0 = np.random.default_rng(9).integers(0, L, S * K)
    jlab, jenergy, jneed, jtabs, partner, jtables = jax_fusion_run(p, lab0)
    assert len(jtabs) == L

    fusion = TGF.make_fusion_fn(p["tst"]._replace(sweeps=1), S,
                                random_starts=jax_group_starts(S * K))
    tables = TGF.build_iteration_tables(partner, p["trip"], S, K, "cpu")
    maps, part = T(p["maps"]), T(partner)
    state = fusion.prepare(T(p["cp"]), T(p["spac"]))
    pair_nodes = fusion.pair_endpoints(part)
    labeling = T(lab0)
    ttabs = []
    for alpha in range(L):
        ttabs.append(tuple(np_(a) for a in fusion.build_tables_for(
            state, maps, part, labeling.reshape(S, K), alpha)))
        labeling = fusion.alpha_step(state, maps, part, tables, pair_nodes,
                                     labeling, alpha)
    energy = float(fusion.energy(state, maps, part, labeling))
    return dict(p=p, jlab=jlab, jenergy=jenergy, jneed=jneed, jtabs=jtabs,
                tlab=np_(labeling), tenergy=energy, ttabs=ttabs,
                tneed=int(state["patch_need"]), fusion=fusion, state=state,
                tables=tables, partner=partner, lab0=lab0)


@pytest.fixture(params=list(VARIANTS))
def sweep_pair(request):
    return run_sweep(request.param)


def test_first_alpha_step_tables_match(sweep_pair):
    """From identical state (random labeling, alpha 0): triplet tables
    (S*T,8) rtol 2e-4 (atol 1e-6) with equal FOLDING entries; pair tables
    (B*K,4) atol 1e-4; equal patch_need."""
    (j8, j4), (t8, t4) = sweep_pair["jtabs"][0], sweep_pair["ttabs"][0]
    p = sweep_pair["p"]
    S, K = p["S"], p["K"]
    assert t8.shape == j8.shape == (S * p["trip"].shape[0], 8)
    assert t4.shape == j4.shape == (S * (S - 1) // 2 * K, 4)
    np.testing.assert_array_equal(t8 >= 1e7, j8 >= 1e7)
    np.testing.assert_allclose(t8, j8, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(t4, j4, atol=1e-4)
    assert np.isfinite(t4).all() and (t4 != t4[:, :1]).any()
    assert sweep_pair["tneed"] == sweep_pair["jneed"]
    assert 0 < sweep_pair["tneed"] <= p["st"].pmax


def test_fusion_sweep_with_injected_starts_matches(sweep_pair):
    """Equal labeling after the sweep, energy rtol 1e-4; and along the
    (equal) trajectory every alpha step's tables agree: pair tables atol
    1e-4, triplet tables rtol 1e-3 (a few strains of ~800 at far labels
    differ by 4.5e-4 relative in float32, beyond the 2e-4 the first step
    holds)."""
    np.testing.assert_array_equal(sweep_pair["tlab"], sweep_pair["jlab"])
    assert (sweep_pair["tlab"] != sweep_pair["lab0"]).any()
    np.testing.assert_allclose(sweep_pair["tenergy"], sweep_pair["jenergy"],
                               rtol=1e-4)
    for (j8, j4), (t8, t4) in zip(sweep_pair["jtabs"], sweep_pair["ttabs"]):
        np.testing.assert_array_equal(t8 >= 1e7, j8 >= 1e7)
        np.testing.assert_allclose(t8, j8, rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(t4, j4, atol=1e-4)


def test_group_fusion_call_equals_its_stages(sweep_pair):
    """GroupFusion.__call__ (what the driver calls) gives the labeling,
    energy and patch_need of the stage-by-stage run above."""
    p = sweep_pair["p"]
    fusion = TGF.make_fusion_fn(p["tst"]._replace(sweeps=1), p["S"],
                                random_starts=jax_group_starts(
                                    p["S"] * p["K"]))
    lab, energy, need = fusion(T(p["maps"]), T(p["cp"]), T(p["spac"]),
                               T(sweep_pair["lab0"]),
                               T(sweep_pair["partner"]), sweep_pair["tables"])
    np.testing.assert_array_equal(np_(lab), sweep_pair["tlab"])
    assert float(energy) == pytest.approx(sweep_pair["tenergy"], rel=1e-6)
    assert int(need) == sweep_pair["tneed"]


def test_patches_are_those_of_a_per_block_build(sweep_pair):
    """The patches built once per call are the (index set, in-range mask)
    of `patch_of` at a block's own positions: same sets as a direct dense
    count of template vertices within the limit."""
    p, state, fusion = sweep_pair["p"], sweep_pair["state"], sweep_pair["fusion"]
    st = p["tst"]
    a, v, lab = 1, 5, 7
    pos = state["rl"][a, v, lab]
    chord = torch.linalg.norm(st.tmpl_coords - pos, dim=-1)
    dist = 2 * 100.0 * torch.arcsin((chord / 200.0).clamp(-1, 1))
    want = set(np.nonzero(np_(dist < st.cprange * T(p["spac"])[a, v]))[0])
    idx = np_(state["p_idx"][a, v, lab])
    rng = np_(state["p_rng"][a, v, lab])
    assert set(idx[rng]) == want and len(want) > 3
    assert state["p_idx"].shape == (p["S"] - 1, p["K"], p["L"], st.pmax)


def test_tiny_case_chosen_energy_not_above_any_start():
    """S = 2, K = 12 (ico-0 control), 7 labels: after every alpha step the
    binary energy of the chosen move is not above that of any start (keep
    all, switch all, greedy, 2 random), and the sweep never raises the
    total energy."""
    control = Mesh.from_icosphere(0)
    control.true_rescale(100.0)
    template = Mesh.from_icosphere(2)
    template.true_rescale(100.0)
    sg = build_sampling_grid(3, 0.25 * control.calculate_MaxVD())
    labels = np.asarray(sg.samples, np.float32)[:7]
    L = labels.shape[0]
    assert L == 7
    S, K = 2, control.nvertices
    trip = np.sort(control.faces.astype(np.int32), axis=1)
    rng = np.random.default_rng(2)
    tc = convert.mesh(control)
    st = TGF.GroupLevelStatics(
        labels=T(labels), centre=T(np.asarray(sg.centre, np.float32)),
        orig_cp=T(control.coords), cp_faces=T(trip),
        tmpl_coords=T(template.coords), mask_w=None,
        cp_search=tnst.build_tables(tc.coords, tc.faces, tc.adjacency[2],
                                    "cpu"),
        mu=0.4, kappa=1.6, k_exp=2.0, rexp=2.0, reglambda=0.05,
        subcorr=0.1 * S, simval=2, percentile=0.75, pmax=64, cprange=1.0,
        fixnan=False)
    cp = np.broadcast_to(np.asarray(control.coords, np.float32),
                         (S, K, 3)).copy()
    cp += rng.normal(size=cp.shape).astype(np.float32) * 2.0
    cp /= np.linalg.norm(cp, axis=-1, keepdims=True) / 100.0
    cp_t = T(cp)
    spac = T(np.broadcast_to(control.max_vertex_distances(), (S, K)).copy())
    maps = T(rng.normal(size=(S, L, 1, template.nvertices)))
    partner = TGF.make_partner_fn(st, S)(cp_t)
    tables = TGF.build_iteration_tables(np_(partner), trip, S, K, "cpu")
    fusion = TGF.make_fusion_fn(st, S,
                                generator=torch.Generator().manual_seed(3))
    state = fusion.prepare(cp_t, spac)
    pair_nodes = fusion.pair_endpoints(partner)
    labeling = torch.zeros(S * K, dtype=torch.int64)
    zero = torch.zeros(S * K)
    total = float(fusion.energy(state, maps, partner, labeling))
    from newmsm_tpu_torch.ops import icm
    for alpha in range(L):
        t8, p4 = fusion.build_tables_for(state, maps, partner,
                                         labeling.reshape(S, K), alpha)
        new = fusion.alpha_step(state, maps, partner, tables, pair_nodes,
                                labeling, alpha)
        # a node already at alpha costs the same kept or switched
        x = (new != labeling).to(torch.int64)
        chosen = float(icm.binary_energy(x, zero, zero, t8,
                                         fusion.trip_nodes, p4, pair_nodes))
        starts = torch.cat([torch.zeros(1, S * K, dtype=torch.int64),
                            torch.ones(1, S * K, dtype=torch.int64),
                            fusion.starts_for(alpha)])
        es = np_(icm.binary_energy(starts, zero, zero, t8, fusion.trip_nodes,
                                   p4, pair_nodes))
        assert chosen <= es.min() + 1e-5 * abs(es.min()), (alpha, chosen, es)
        labeling = new
        now = float(fusion.energy(state, maps, partner, labeling))
        assert now <= total + 1e-5 * abs(total), (alpha, total, now)
        total = now
    assert (labeling != 0).any()


def test_random_starts_are_required_and_kept_per_alpha():
    p = build_problem(2)
    fusion = TGF.GroupFusion(p["tst"], 2)
    with pytest.raises(ValueError):
        fusion.starts_for(0)
    fusion = TGF.make_fusion_fn(p["tst"], 2)       # seeded generator
    a = fusion.starts_for(3)
    assert a.shape == (2, 2 * p["K"]) and fusion.starts_for(3) is a
    assert TGF.make_fusion_fn(p["tst"]._replace(n_restarts=0),
                              2).starts_for(0) is None


# --------------------------------------------------------------- apply stage

def test_apply_stage_matches():
    """The labeling of the fusion sweep applied to warped grids. Both
    fold-free; CP and data-grid coordinates within 1e-3 (radius 100),
    spacings within 1e-3."""
    from newmsm_tpu.ops.unfold import count_folds as jfolds
    sweep_pair = run_sweep("corr")
    p = sweep_pair["p"]
    S = p["S"]
    dg = warped_icosphere(3, seed=1, deg=3.0)
    dg_coords = np.stack([warped_icosphere(3, seed=10 + s, deg=3.0).coords
                          for s in range(S)]).astype(np.float32)
    labeling = sweep_pair["jlab"]
    japply = JGF.make_apply_fn(one_device_mesh(), p["st"], S, p["control"],
                               Mesh.from_icosphere(3))
    jd, jc, js = (np_(a) for a in japply(
        jnp.asarray(dg_coords), jnp.asarray(p["cp"]),
        jnp.asarray(labeling, jnp.int32)))
    tapply = TGF.make_apply_fn(p["tst"], S, convert.mesh(p["control"]),
                               TMesh.from_icosphere(3))
    td, tc, ts = (np_(a) for a in tapply(T(dg_coords), T(p["cp"]),
                                         T(labeling)))
    np.testing.assert_allclose(tc, jc, atol=1e-3)
    np.testing.assert_allclose(td, jd, atol=1e-3)
    np.testing.assert_allclose(ts, js, atol=1e-3)
    assert np.abs(tc - p["cp"]).max() > 1.0          # the CPs moved
    for s in range(S):
        for coords, faces in ((td[s], dg.faces), (tc[s], p["control"].faces)):
            assert tfolds(TMesh(coords=coords.astype(np.float64),
                                faces=faces), device="cpu") == 0
            assert jfolds(Mesh(coords=coords.astype(np.float64),
                               faces=faces)) == 0


# ------------------------------------------------------------ whole driver

def torch_config(cfg):
    out = TRegConfig()
    out.__dict__.update(cfg.__dict__)
    return out


def rotated_template(res=3):
    """An icosphere rotated off the data grid: no template vertex lies on a
    data-grid edge, so the label maps carry no face ties."""
    m = Mesh.from_icosphere(res)
    m.coords = m.coords @ rotation_matrix([0.3, 1.0, 0.5], 17.0).T
    return m


def run_both(meshes, datasets, template, cfg, tmp_path, mask=None,
             small_pmax=None):
    """The group driver in both packages (the port on the CPU with the JAX
    package's random starts). `small_pmax` cuts the first level's patch
    capacity after its set-up in both, so the regrow loop must run."""
    out = {}
    S = len(meshes)
    for name in ("jax", "torch"):
        if name == "jax":
            cls, conv, config = JGroup, (lambda m: m), cfg
        else:
            cls, conv, config = TGroup, convert.mesh, torch_config(cfg)

        class Driver(cls):
            def _initialize_level(self, level):
                super()._initialize_level(level)
                if small_pmax is not None:
                    self.pmax = small_pmax
                    self.level_statics = self.level_statics._replace(
                        pmax=small_pmax)
                    if name == "jax":
                        self._fusion_fn = JGF.make_fusion_fn(
                            self.device_mesh, self.level_statics, S,
                            maps_exchange=self._maps_exchange_used)
                    else:
                        self._fusion_fn = self._make_fusion_fn()

        g = Driver() if name == "jax" else Driver(device="cpu")
        if name == "torch":
            # the JAX package's draws for the running level's node count
            g.fusion_random_starts = lambda alpha, g=g: jax_group_starts(
                S * g.control.nvertices)(alpha)
        g.set_inputs([conv(m) for m in meshes])
        g.set_data_list([d.copy() for d in datasets])
        g.set_template(conv(template))
        if mask is not None:
            g.set_mask(mask)
        g.outdir = str(tmp_path / name) + "_"
        g.metrics_path = g.outdir + "metrics.jsonl"
        g.run_multiresolutions(config)
        out[name] = g
    return out["jax"], out["torch"]


def _events(g):
    return [json.loads(line) for line in open(g.metrics_path)
            if json.loads(line)["event"] == "iter"]


def test_group_driver_matches_off_the_ties(tmp_path):
    """make_group(3), group_config(iters=3), cprange 1.1, template rotated
    off the data grid: first energy rtol 1e-3 (measured 2e-7), every
    energy rtol 1e-3, mean pairwise CC after above before and within 0.02
    of the JAX package's (measured 2e-8); 0 folds, patch_overflow 0."""
    meshes, datasets = make_group(3, degrees=8.0)
    cfg = group_config(iters=3)
    cfg.cprange = 1.1
    j, t = run_both(meshes, datasets, rotated_template(), cfg, tmp_path)
    je = [e for _, _, e in j.energy_log]
    te = [e for _, _, e in t.energy_log]
    assert len(je) == len(te)
    np.testing.assert_allclose(te[0], je[0], rtol=1e-3)
    np.testing.assert_allclose(te, je, rtol=1e-3)
    before = mean_pairwise_corr(datasets)
    jcc = mean_pairwise_corr(j.transformed_data)
    tcc = mean_pairwise_corr(t.transformed_data)
    assert tcc > before and abs(tcc - jcc) <= 0.02, (before, jcc, tcc)
    for s in range(3):
        assert tfolds(t.sph_reg[s], device="cpu") == 0
        assert (tmp_path / f"torch_sphere-{s}.reg.surf.gii").exists()
        assert (tmp_path /
                f"torch_transformed_and_reprojected-{s}.func.gii").exists()
    ev = _events(t)
    assert all(e["patch_overflow"] == 0 and e["devices"] == 1 for e in ev)
    assert [e["energy"] for e in ev] == te


def test_group_driver_on_the_pristine_template(tmp_path):
    """The configuration of tests/test_group.py itself (pristine ico-3
    template, where the first iteration's label maps carry face ties, see
    the module docstring): CC after above before and within 0.02 of the
    JAX package's (measured 0.9574 / 0.9541); first energy rtol 5e-2
    (measured 2.4e-2), not the 1e-3 that holds off the ties."""
    meshes, datasets = make_group(3, degrees=8.0)
    cfg = group_config(iters=3)
    cfg.cprange = 1.1
    j, t = run_both(meshes, datasets, Mesh.from_icosphere(3), cfg, tmp_path)
    np.testing.assert_allclose(t.energy_log[0][2], j.energy_log[0][2],
                               rtol=5e-2)
    before = mean_pairwise_corr(datasets)
    jcc = mean_pairwise_corr(j.transformed_data)
    tcc = mean_pairwise_corr(t.transformed_data)
    assert tcc > before and abs(tcc - jcc) <= 0.02, (before, jcc, tcc)


def test_group_driver_two_levels(tmp_path):
    """The two-level case of tests/test_group.py (data grids 3/4, CP 1/2):
    the second level starts from the first level's warps projected onto the
    new data grid. CC after above before and within 0.02 of the JAX
    package's."""
    meshes, datasets = make_group(2, degrees=6.0, res=4)
    cfg = group_config(iters=2)
    cfg.cost = ["DISCRETE", "DISCRETE"]
    cfg.simval = [2, 2]
    cfg.iters = [2, 2]
    cfg.sigma_in = [0.0, 0.0]
    cfg.sigma_ref = [0.0, 0.0]
    cfg.reglambda = [0.1, 0.1]
    cfg.datagrid = [3, 4]
    cfg.cpgrid = [1, 2]
    cfg.sampgrid = [3, 4]
    cfg.anatgrid = [3, 4]
    cfg.mciters = [50, 50]
    cfg.cprange = 1.1
    j, t = run_both(meshes, datasets, rotated_template(4), cfg, tmp_path)
    assert [lv for lv, _, _ in t.energy_log] == [1, 1, 2, 2]
    assert t.sph_reg[0].nvertices == 2562
    before = mean_pairwise_corr(datasets)
    jcc = mean_pairwise_corr(j.transformed_data)
    tcc = mean_pairwise_corr(t.transformed_data)
    assert tcc > before and abs(tcc - jcc) <= 0.02, (before, jcc, tcc)
    np.testing.assert_allclose(t.energy_log[0][2], j.energy_log[0][2],
                               rtol=1e-3)


def test_group_driver_mask_case(tmp_path):
    """The mask case of tests/test_group.py: a half-sphere template mask
    weights the similarity; first energy rtol 1e-3, CC within 0.02."""
    meshes, datasets = make_group(2, degrees=6.0)
    tmpl = rotated_template()
    mask = (tmpl.coords[:, 2] < 0).astype(float)
    cfg = group_config(iters=2)
    cfg.cprange = 1.1
    j, t = run_both(meshes, datasets, tmpl, cfg, tmp_path, mask=mask)
    assert len(t.transformed_data) == 2
    np.testing.assert_allclose(t.energy_log[0][2], j.energy_log[0][2],
                               rtol=1e-3)
    assert abs(mean_pairwise_corr(t.transformed_data)
               - mean_pairwise_corr(j.transformed_data)) <= 0.02


def test_pmax_regrow_ends_at_the_reference_capacity(tmp_path):
    """Start with pmax = 16 (patches hold ~70-190 template vertices): both
    drivers grow it once from the measured need, to the same value, redo
    the iteration, and log patch_overflow 0."""
    meshes, datasets = make_group(2, degrees=6.0)
    cfg = group_config(iters=1)
    cfg.cprange = 1.1
    j, t = run_both(meshes, datasets, rotated_template(), cfg, tmp_path,
                    small_pmax=16)
    assert t.pmax == j.pmax and t.pmax > 16
    assert t.level_statics.pmax == t.pmax
    ev = _events(t)
    assert len(ev) == 1 and ev[0]["patch_overflow"] == 0
    assert ev[0]["pmax"] == t.pmax
    np.testing.assert_allclose(t.energy_log[0][2], j.energy_log[0][2],
                               rtol=1e-3)


def test_group_requires_multiple_subjects():
    g = TGroup(device="cpu")
    g.set_inputs([TMesh.from_icosphere(2)])
    g.set_data_list([np.zeros((1, 162))])
    g.set_template(TMesh.from_icosphere(2))
    with pytest.raises(ValueError, match="at least 2"):
        g.run_multiresolutions(torch_config(group_config()))


@pytest.mark.parametrize("cost", ["RIGID", "AFFINE"])
def test_group_rejects_rigid(cost):
    meshes, datasets = make_group(2)
    g = TGroup(device="cpu")
    g.set_inputs([convert.mesh(m) for m in meshes])
    g.set_data_list(datasets)
    g.set_template(TMesh.from_icosphere(3))
    cfg = torch_config(group_config())
    cfg.cost = [cost]
    with pytest.raises(ValueError, match="not supported in groupwise"):
        g.run_multiresolutions(cfg)


def test_group_needs_a_template_and_matching_lists():
    meshes, datasets = make_group(2)
    g = TGroup(device="cpu")
    g.set_inputs([convert.mesh(m) for m in meshes])
    g.set_data_list(datasets)
    with pytest.raises(ValueError, match="template"):
        g.run_multiresolutions(torch_config(group_config()))
    g.set_data_list(datasets[:1])
    with pytest.raises(ValueError, match="mismatch"):
        g.run_multiresolutions(torch_config(group_config()))


def test_group_driver_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TGroup()


# ------------------------------------------------------------------ the CLIs

GROUP_CLI_CONFIG = """\
--opt=DISCRETE
--simval=2
--it=2
--sigma_in=0
--sigma_ref=0
--lambda=0.1
--datagrid=3
--CPgrid=1
--SGgrid=3
--anatgrid=3
--dopt=HOCR
--regoption=3
--cprange=1.1
"""


def test_groupwise_through_both_clis(tmp_path):
    """--groupwise with list files through the JAX package's CLI and the
    port's (--device cpu, --debug, --profile): one sphere and one
    transformed map a subject, 0 folds, CC raised in both and within 0.02
    of each other."""
    from newmsm_tpu import cli as jcli
    from newmsm_tpu.core import io as mio
    from newmsm_tpu_torch import cli as tcli
    meshes, datasets = make_group(3, degrees=8.0)
    template = rotated_template()
    d = tmp_path
    mesh_paths, data_paths = [], []
    for s, (m, data) in enumerate(zip(meshes, datasets)):
        mesh_paths.append(str(d / f"s{s}.surf.gii"))
        data_paths.append(str(d / f"s{s}.func.gii"))
        m.save(mesh_paths[-1])
        Mesh(coords=m.coords, faces=m.faces, data=data).save(data_paths[-1])
    (d / "meshes.txt").write_text("\n".join(mesh_paths) + "\n")
    (d / "data.txt").write_text("\n".join(data_paths) + "\n\n")
    template.save(str(d / "template.surf.gii"))
    (d / "config").write_text(GROUP_CLI_CONFIG)
    args = ["--groupwise", "--meshes", str(d / "meshes.txt"), "--data",
            str(d / "data.txt"), "--template", str(d / "template.surf.gii"),
            "--conf", str(d / "config")]
    before = mean_pairwise_corr(datasets)
    cc = {}
    for name, main, extra in (
            ("jax", jcli.main, ()),
            ("torch", tcli.main, ("--device", "cpu", "--debug", "--profile",
                                  str(d / "profile")))):
        prefix = str(d / name) + "_"
        assert main([*args, "-o", prefix, "--metrics", prefix + "m.jsonl",
                     *extra]) == 0
        maps = []
        for s in range(3):
            sphere = TMesh.load(prefix + f"sphere-{s}.reg.surf.gii")
            assert tfolds(sphere, device="cpu") == 0
            maps.append(mio.load_data(
                prefix + f"transformed_and_reprojected-{s}.func.gii",
                template))
            assert maps[-1].shape == (1, 642) and np.isfinite(maps[-1]).all()
        cc[name] = mean_pairwise_corr(maps)
        assert cc[name] > before, (name, before, cc)
    assert abs(cc["torch"] - cc["jax"]) <= 0.02, cc
    events = [json.loads(line) for line in open(str(d / "torch_m.jsonl"))]
    kinds = [e["event"] for e in events]
    assert kinds.count("iter") == 2 and "level" in kinds and "outputs" in kinds
    assert (d / "profile" / "trace.json").stat().st_size > 1000
    # --debug dumps every subject's grids at every iteration
    for s in range(3):
        for it in range(2):
            assert (d / f"torch_SOURCE-{s}-1-{it}.surf.gii").exists()
            assert (d / f"torch_CPgrid-{s}-1-{it}.surf.gii").exists()


def test_port_cli_groupwise_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from newmsm_tpu_torch import cli as tcli
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--groupwise", "--meshes", "none.txt", "--data",
                   "none.txt", "--template", "none.surf.gii"])
