"""Tests of newmsm_tpu_torch that need a CUDA card: the hand-written
locate kernel against its plain PyTorch version on the card (on the
sphere, off it, and at the size of a triclique call), the MCMC colour
scatter and the face-patch scatter on the card against the CPU, the
groupwise path's fusion tables and label maps on the card against the CPU,
its subject-sharded fusion call on the card (a 1-rank NCCL group, two
gloo ranks sharing the card) against the one-device call, and run_cgmsm
over NCCL ranks, a card each (where there are two or more), against one
rank; the binary-ICM kernel K2 against its plain version in the three
forms its callers pass, on synthetic and on recorded tables; and the
rigid-cost kernel K3 against its plain version at AFFINE's shapes and at
the edges of its arithmetic, alone and inside rigid_align; and the
label-map kernel K4 against its plain version at the last gMSM level's
shape. They skip
without one. The machine with the card has no JAX, so
this file imports neither JAX nor the JAX package, and is run there
without tests/conftest.py (which imports JAX):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from newmsm_tpu_torch.core.icosphere import icosphere
from newmsm_tpu_torch.core.mesh import Mesh


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _positions(res, fid, w):
    ico = icosphere(res)
    W = torch.stack(w, 1).double().cpu().numpy()
    return (ico.coords[ico.faces[fid.cpu().numpy()]] * W[..., None]).sum(1)


@pytest.mark.cuda
@pytest.mark.parametrize("res", [0, 3, 6])
def test_kernel_matches_twin_on_card(cuda, res):
    """Face ids equal but for at most 1e-4 of random queries, each a
    boundary tie: positions agree to 2e-4 on the unit sphere (the JAX
    package's on-device probe tolerances, pallas_locate.py:149-158)."""
    from newmsm_tpu_torch.ops import locate
    g = torch.Generator().manual_seed(res)
    q = (torch.randn((1 << 16, 3), generator=g) * 100.0).to(cuda)
    px, py, pz = (q[:, i].contiguous() for i in range(3))
    before = locate.SEAM.tally["kernel"]
    fid_k, *wk = locate.locate_bary(px, py, pz, res)
    fid_p, *wp = locate.locate_bary_reference(px, py, pz, res)
    torch.cuda.synchronize()
    assert locate.SEAM.tally["kernel"] == before + 1
    assert fid_k.dtype == torch.int32 and fid_k.device == q.device
    assert (fid_k != fid_p).sum().item() <= 1e-4 * q.shape[0]
    np.testing.assert_allclose(_positions(res, fid_k, wk),
                               _positions(res, fid_p, wp), atol=2e-4)
    np.testing.assert_allclose(torch.stack(wk, 1).sum(1).cpu().numpy(), 1.0,
                               atol=1e-4)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs(cuda):
    from newmsm_tpu_torch.ops import locate
    x = torch.ones(8, device=cuda)
    with pytest.raises(TypeError):
        locate.locate_bary(x.double(), x.double(), x.double(), 2)
    with pytest.raises(ValueError):
        locate.locate_bary(x[::2], x[::2], x[::2], 2)


def _compare_with_twin(locate, q, res):
    px, py, pz = (q[:, i].contiguous() for i in range(3))
    fid_k, *wk = locate.locate_bary(px, py, pz, res)
    fid_p, *wp = locate.locate_bary_reference(px, py, pz, res)
    torch.cuda.synchronize()
    assert (fid_k != fid_p).sum().item() <= 1e-4 * q.shape[0]
    W = torch.stack(wk, 1)
    assert torch.isfinite(W).all()
    np.testing.assert_allclose(_positions(res, fid_k, wk),
                               _positions(res, fid_p, wp), atol=2e-4)
    np.testing.assert_allclose(W.sum(1).cpu().numpy(), 1.0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("res", [4, 6])
def test_kernel_matches_twin_off_the_sphere(cuda, res):
    """Queries at radius 0.5 .. 150, as the anatomical cost (regoption 5)
    sends them (raw barycentric combinations): the kernel normalises, so
    face ids and weights agree with the twin as on the sphere."""
    from newmsm_tpu_torch.ops import locate
    g = torch.Generator().manual_seed(10 + res)
    q = torch.randn((1 << 17, 3), generator=g)
    q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    q = q * (0.5 + 149.5 * torch.rand((q.shape[0], 1), generator=g))
    _compare_with_twin(locate, q.to(cuda), res)


@pytest.mark.cuda
def test_kernel_matches_twin_on_a_two_million_query_call(cuda):
    """One call of 5,120 x 8 x 48 = 1,966,080 queries at res 6: the size of
    a triclique likelihood call at CP ico-4 on an ico-6 data grid."""
    from newmsm_tpu_torch.ops import locate
    g = torch.Generator().manual_seed(3)
    q = torch.randn((5120 * 8 * 48, 3), generator=g) * 100.0
    _compare_with_twin(locate, q.to(cuda), 6)


def _mcmc_problem(seed=0, L=7, res=2):
    from newmsm_tpu_torch.reg.optimise.coloring import (color_groups,
                                                        face_coloring)
    ico = icosphere(res)
    trip = np.sort(ico.faces.astype(np.int64), axis=1)
    K, T = ico.nvertices, trip.shape[0]
    rng = np.random.default_rng(seed)
    groups, mask = color_groups(face_coloring(trip, K))
    return dict(
        unary=torch.from_numpy(rng.normal(size=(L, K)).astype(np.float32)),
        tcosts=torch.from_numpy(
            rng.gamma(2.0, 0.5, size=(T, L, L, L)).astype(np.float32)),
        trip=torch.from_numpy(trip),
        groups=torch.from_numpy(groups.astype(np.int64)),
        mask=torch.from_numpy(mask)), K, L


@pytest.mark.cuda
def test_mcmc_colour_scatter_is_the_same_on_cuda_and_cpu(cuda):
    """The same proposals on both devices give the same labeling: the
    colour step's label write has no duplicate index, and argmin takes the
    first minimum on both (a block of equal costs is in the volume)."""
    from newmsm_tpu_torch.reg.optimise import mcmc
    p, K, L = _mcmc_problem()
    p["tcosts"][:40] = 1.0                   # ties: every combination equal
    R, sweeps = 8, 5
    draws = torch.randint(0, L, (sweeps,) + tuple(p["groups"].shape) + (R,),
                          generator=torch.Generator().manual_seed(1))
    out = []
    for dev in ("cpu", cuda):
        t = {k: v.to(dev) for k, v in p.items()}
        out.append(mcmc.mcmc_optimise(
            torch.zeros(K, dtype=torch.int64, device=dev), t["unary"],
            t["tcosts"], t["trip"], t["groups"], t["mask"],
            mciters=R * sweeps, num_labels=L, proposals=R,
            draws=draws).cpu().numpy())
    np.testing.assert_array_equal(out[1], out[0])
    assert (out[0] != 0).any()
    # and from the card's own generator: reproducible for a seed
    t = {k: v.to(cuda) for k, v in p.items()}
    runs = [mcmc.mcmc_optimise(
        torch.zeros(K, dtype=torch.int64, device=cuda), t["unary"],
        t["tcosts"], t["trip"], t["groups"], t["mask"],
        torch.Generator(device=cuda).manual_seed(5), mciters=64,
        num_labels=L, proposals=R).cpu().numpy() for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("fmax", [3, 64])
def test_face_patch_scatter_is_the_same_on_cuda_and_cpu(cuda, fmax):
    """build_face_patches (stable sort, masked scatter into distinct slots)
    on a warped CP grid: equal tables, masks and overflow on both devices,
    but for source vertices whose nearest face is a tie between the twin
    and the kernel's search (none on this warped grid)."""
    from newmsm_tpu_torch.eval.synth import smooth_sphere_warp
    from newmsm_tpu_torch.ops.nearest import build_tables
    from newmsm_tpu_torch.reg.costs import build_face_patches
    cp = icosphere(1)
    cp_coords = smooth_sphere_warp(cp.coords, 5, 2.0) * 100.0
    adj = Mesh(coords=cp_coords, faces=cp.faces).adjacency[2]
    src = (smooth_sphere_warp(icosphere(4).coords, 2, 3.0) * 100.0
           ).astype(np.float32)
    out = []
    for dev in ("cpu", cuda):
        tables = build_tables(cp_coords, cp.faces, adj, dev)
        out.append([a.cpu().numpy() for a in build_face_patches(
            torch.from_numpy(src).to(dev), tables, fmax)])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    assert out[0][2].any() == (fmax == 3)


def _group_problem(device, S=3, seed=5):
    """A group level's statics and warped state on `device` (CP ico-1,
    template ico-3, 2 channels), from numpy seeds."""
    from newmsm_tpu_torch.ops.nearest import build_tables
    from newmsm_tpu_torch.parallel import group_fusion as GF
    from newmsm_tpu_torch.reg.sampling_grid import build_sampling_grid
    control = Mesh.from_icosphere(1)
    template = Mesh.from_icosphere(3)
    sg = build_sampling_grid(3, 0.5 * control.calculate_MaxVD())
    K = control.nvertices
    trip = np.sort(control.faces.astype(np.int64), axis=1)
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(device)

    st = GF.GroupLevelStatics(
        labels=f32(sg.samples), centre=f32(sg.centre),
        orig_cp=f32(control.coords), cp_faces=torch.as_tensor(trip).to(device),
        tmpl_coords=f32(template.coords), mask_w=None,
        cp_search=build_tables(control.coords, control.faces,
                               control.adjacency[2], device),
        mu=0.4, kappa=1.6, k_exp=2.0, rexp=2.0, reglambda=0.1,
        subcorr=0.1 * S, simval=2, percentile=0.75, pmax=128, cprange=1.0,
        fixnan=False)
    cp = np.broadcast_to(control.coords, (S, K, 3)).copy()
    cp += rng.normal(size=cp.shape) * 1.5
    cp /= np.linalg.norm(cp, axis=-1, keepdims=True) / 100.0
    spac = np.broadcast_to(control.max_vertex_distances(), (S, K)).copy()
    maps = rng.normal(size=(S, len(sg.samples), 2, template.nvertices))
    lab0 = rng.integers(0, len(sg.samples), S * K)
    return st, trip, f32(cp), f32(spac), f32(maps), torch.as_tensor(lab0).to(
        device)


@pytest.mark.cuda
def test_group_fusion_tables_are_the_same_on_cuda_and_cpu(cuda):
    """From the same state: equal partner map, colouring and patch_need;
    one alpha step's triplet tables rtol 1e-3 with equal FOLDING entries
    (float32 strains: the card's sin / cos / acos differ from the CPU's in
    the last bits, and a small strain is a difference of near-equal terms;
    measured 5.3e-4 on an H100), pair tables atol 1e-4; and, from the same
    injected starts, the same labeling after the step but for at most 2 %
    of the nodes (near-tie flips)."""
    from newmsm_tpu_torch.parallel import group_fusion as GF
    S = 3
    out = {}
    starts = torch.randint(0, 2, (2, S * 42),
                           generator=torch.Generator().manual_seed(1))
    for dev in (torch.device("cpu"), cuda):
        st, trip, cp, spac, maps, lab0 = _group_problem(dev, S)
        partner = GF.make_partner_fn(st, S)(cp)
        tables = GF.build_iteration_tables(partner.cpu().numpy(), trip, S, 42,
                                           dev)
        fusion = GF.make_fusion_fn(st, S, random_starts=lambda alpha: starts)
        state = fusion.prepare(cp, spac)
        t8, p4 = fusion.build_tables_for(state, maps, partner,
                                         lab0.reshape(S, 42), 4)
        lab = fusion.alpha_step(state, maps, partner, tables,
                                fusion.pair_endpoints(partner), lab0, 4)
        assert t8.device.type == dev.type
        out[dev.type] = (partner.cpu().numpy(), tables.colors,
                         int(state["patch_need"]), t8.cpu().numpy(),
                         p4.cpu().numpy(), lab.cpu().numpy())
    c, g = out["cpu"], out["cuda"]
    np.testing.assert_array_equal(g[0], c[0])
    np.testing.assert_array_equal(g[1], c[1])
    assert g[2] == c[2]
    np.testing.assert_array_equal(g[3] >= 1e7, c[3] >= 1e7)
    np.testing.assert_allclose(g[3], c[3], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(g[4], c[4], atol=1e-4)
    assert (g[5] != c[5]).mean() <= 0.02, (g[5] != c[5]).sum()
    assert (g[5] == 4).any()


@pytest.mark.cuda
def test_label_deformed_maps_go_through_the_kernel(cuda):
    """On the card the forward maps of every label are one K4 launch and
    their reverse maps one K1 launch of L x N queries; against the plain
    version (the same function on the CPU): all entries within 1e-3, all
    but 1e-3 of them within 1e-4 (the kernels' ties against their twins
    are boundary ties, which move a ~0 weight)."""
    from newmsm_tpu_torch.eval.synth import smooth_sphere_warp
    from newmsm_tpu_torch.ops import labelmap, locate, resample as rsp
    from newmsm_tpu_torch.ops.nearest import build_tables
    from newmsm_tpu_torch.reg.sampling_grid import build_sampling_grid
    res = 4
    dg = Mesh.from_icosphere(res)
    warped = smooth_sphere_warp(dg.coords / 100.0, 3, 4.0) * 100.0
    tm = Mesh.from_icosphere(res)
    control = Mesh.from_icosphere(2)
    sg = build_sampling_grid(4, 0.5 * control.calculate_MaxVD())
    data = np.random.default_rng(0).normal(size=(2, dg.nvertices))
    tri_idx = dg.adjacency[2]
    got = {}
    for dev in (torch.device("cpu"), cuda):
        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(dev)
        tabs = build_tables(dg.coords, dg.faces, tri_idx, dev)
        ttm = build_tables(tm.coords, tm.faces, tm.adjacency[2], dev)
        assert ttm.pristine_res == res
        before = (locate.SEAM.tally["kernel"], labelmap.SEAM.tally["kernel"])
        got[dev.type] = rsp.label_deformed_maps(
            f32(warped), f32(data), tabs.faces,
            torch.as_tensor(tri_idx.astype(np.int64)).to(dev),
            tabs.ring_faces, tabs.ring_verts, f32(sg.samples), f32(sg.centre),
            ttm, f32(tm.vertex_area()),
            cap=rsp._adaptive_cap(dg.nvertices, tm.nvertices)).cpu().numpy()
        launched = (locate.SEAM.tally["kernel"] - before[0],
                    labelmap.SEAM.tally["kernel"] - before[1])
        assert launched == ((1, 1) if dev.type == "cuda" else (0, 0))
    err = np.abs(got["cuda"] - got["cpu"])
    assert err.max() < 1e-3, err.max()
    assert (err > 1e-4).mean() <= 1e-3, (err > 1e-4).sum()


@pytest.mark.cuda
def test_label_forward_kernel_matches_its_twin_at_ico6(cuda):
    """K4 on a warped ico-6 data grid with its 18 labels (CP ico-4, SG 6)
    and the ico-6 template, against the plain version on the CPU from the
    same grids (every label, every 7th template vertex): the same triangle
    on every row but at most 1e-4 of them, each a near tie of exact
    distances; the weights of the other rows within 1e-6
    (ops/labelmap_bench.py). Two launches give the same bits."""
    from newmsm_tpu_torch.ops import labelmap, labelmap_bench as lb
    p = lb.problem(6, "cpu")
    got = lb.compare(p)
    print(f"K4 ico-6: {got}")
    assert got["labels"] == 18
    assert got["ok"], got
    on_card = tuple(t.to(cuda) for t in p)
    one, two = labelmap.label_forward(*on_card), labelmap.label_forward(
        *on_card)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.cuda
def test_label_forward_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from newmsm_tpu_torch.ops import labelmap, labelmap_bench as lb
    grids, faces, ring_faces, ring_verts, tmpl = lb.problem(4, cuda)
    with pytest.raises(TypeError):
        labelmap.label_forward(grids.double(), faces, ring_faces, ring_verts,
                               tmpl)
    with pytest.raises(TypeError):
        labelmap.label_forward(grids, faces, ring_faces,
                               ring_verts.int(), tmpl)
    with pytest.raises(ValueError):
        labelmap.label_forward(grids[:, ::2], faces, ring_faces, ring_verts,
                               tmpl)
    with pytest.raises(ValueError):
        labelmap.label_forward(grids, faces, ring_faces, ring_verts[:-1],
                               tmpl)
    with pytest.raises(ValueError):
        labelmap.label_forward(grids, faces, ring_faces, ring_verts,
                               tmpl.cpu())


def _sharded_fusion_on_card(S, exchange):
    """One fusion call of _group_problem(cuda:0, S) from labeling lab0 over
    the default process group's ranks (this process alone when there is
    none), every rank on cuda:0; numpy results."""
    from newmsm_tpu_torch.parallel import group_fusion as GF
    from newmsm_tpu_torch.parallel import multihost as mh
    dev = torch.device("cuda", 0)
    st, trip, cp, spac, maps, lab0 = _group_problem(dev, S)
    comm = mh.default_comm()
    own = mh.process_subject_slice(S, comm)
    partner = GF.make_partner_fn(st, S, comm)(cp[own])
    tables = GF.build_iteration_tables(partner.cpu().numpy(), trip, S, 42,
                                       dev)
    fusion = GF.make_fusion_fn(st._replace(sweeps=1), S, comm=comm,
                               maps_exchange=exchange)
    lab, energy, need = fusion(maps[own], cp[own], spac[own], lab0, partner,
                               tables)
    return (partner.cpu().numpy(), lab.cpu().numpy(), float(energy),
            int(need))


def _assert_same_fusion(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == want[2:], (got[2:], want[2:])


@pytest.mark.cuda
def test_fusion_under_a_one_rank_nccl_group_is_the_call_without_one(cuda):
    """S = 4 on cuda:0: the fusion call in a 1-rank NCCL process group
    gives bitwise the partner map, labeling, energy and patch_need of the
    call in a process with no group."""
    from newmsm_tpu_torch.parallel import multihost as mh
    want = _sharded_fusion_on_card(4, "gather")
    assert (want[1] != 0).any()
    got, = mh.run_local_ranks(_sharded_fusion_on_card, 1, args=(4, "gather"),
                              backend="nccl", timeout=300)
    _assert_same_fusion(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["gather", "ring"])
def test_two_gloo_ranks_sharing_the_card_give_the_one_device_call(cuda,
                                                                  exchange):
    """S = 4, two ranks on cuda:0 under gloo (NCCL refuses two ranks on
    one card): every rank gives bitwise the one-device call's results."""
    from newmsm_tpu_torch.parallel import multihost as mh
    want = _sharded_fusion_on_card(4, "gather")
    for got in mh.run_local_ranks(_sharded_fusion_on_card, 2,
                                  args=(4, exchange), backend="gloo",
                                  timeout=300):
        _assert_same_fusion(got, want)


_GROUPS = {"A": ["s0", "s1"], "B": ["s2"], "C": ["s3"]}
_TREE = [("A", "B", "AB"), ("AB", "C", "ABC")]


def _cgmsm_on_card(tmp, ranked):
    """run_cgmsm on synth_cohort(3, 4, seed=0) (the parity tool's FAST
    groupwise config at one iteration a level) on this rank's card, over
    the default group when `ranked`, else alone; and the host-array
    collectives of the group."""
    import os

    import torch.distributed as dist
    from newmsm_tpu_torch.core.mesh import Mesh
    from newmsm_tpu_torch.eval.synth import synth_cohort
    from newmsm_tpu_torch.parallel import multihost as mh
    from newmsm_tpu_torch.pipelines import gmsm
    from newmsm_tpu_torch.tools import parity
    group = dist.group.WORLD if ranked else None
    comm = mh.SubjectComm(group)
    if ranked:                 # node registrations write under "./"
        os.chdir(os.path.join(tmp, f"rank{comm.rank}"))
    meshes, datasets, _ = synth_cohort(3, 4, seed=0)
    tmpl = Mesh.from_icosphere(3)
    tmpl.true_rescale(100.0)
    subjects = {f"s{i}": (meshes[i], datasets[i]) for i in range(4)}
    state = gmsm.run_cgmsm(_GROUPS, _TREE, subjects, tmpl,
                           parity.config("groupwise", fast=True, iters=1),
                           device=mh.rank_device("cuda"), group=group)
    mine = [np.full((comm.rank + 1, 3), np.pi), np.arange(comm.rank,
                                                          dtype=np.int32)]
    return dict(
        state={gid: (v["members"], v["mean"],
                     {s: m.coords for s, m in v["meshes"].items()})
               for gid, v in state.items()},
        gathered=comm.all_gather_arrays(mine),
        bcast=comm.broadcast_arrays(mine, src=comm.world - 1))


@pytest.mark.cuda
def test_cgmsm_over_nccl_ranks_a_card_each_is_the_one_rank_state(
        cuda, tmp_path, monkeypatch):
    """min(4, cards) NCCL ranks, a card each (at 3 or more, cgMSM's
    2-subject nodes run on a 2-rank NCCL sub-group and the others take
    them by broadcast): every rank's run_cgmsm state is bitwise that of
    one rank on cuda:0, and the host-array collectives return every
    rank's arrays bit for bit, dtypes kept."""
    from newmsm_tpu_torch.parallel import multihost as mh
    world = min(4, torch.cuda.device_count())
    if world < 2:
        pytest.skip("needs two CUDA cards for NCCL ranks")
    for r in range(world):
        (tmp_path / f"rank{r}").mkdir()
    monkeypatch.chdir(tmp_path)
    want = _cgmsm_on_card(str(tmp_path), False)["state"]
    outs = mh.run_local_ranks(_cgmsm_on_card, world,
                              args=(str(tmp_path), True), backend="nccl",
                              timeout=600)
    gathered = []
    for r in range(world):
        gathered += [np.full((r + 1, 3), np.pi),
                     np.arange(r, dtype=np.int32)]
    for r, out in enumerate(outs):
        assert list(out["state"]) == list(want)
        for gid, (members, mean, coords) in want.items():
            got = out["state"][gid]
            assert got[0] == members
            np.testing.assert_array_equal(got[1], mean)
            assert list(got[2]) == list(coords)
            for s in coords:
                np.testing.assert_array_equal(got[2][s], coords[s])
        for got, exp in zip(out["gathered"], gathered, strict=True):
            assert got.dtype == exp.dtype
            np.testing.assert_array_equal(got, exp)
        for got, exp in zip(out["bcast"], gathered[-2:], strict=True):
            assert got.dtype == exp.dtype
            np.testing.assert_array_equal(got, exp)


# ------------------------------------------------------------------ K2 (ICM)

# (form, grid level, subjects): the pairwise grids ico-2/3/4 (K = 162,
# 642, 2,562) in the triplet and pair forms, the group's N for S = 8 at
# CP ico-4 (20,496 nodes) and ico-5 (81,936: x above 48 KB of shared
# memory), and a triplet move at ico-7 (163,842: x in device memory)
_ICM_CASES = [("t8", 2, 1), ("t8", 3, 1), ("t8", 4, 1), ("p4", 2, 1),
              ("p4", 3, 1), ("p4", 4, 1), ("group", 4, 8), ("group", 5, 8),
              ("t8", 7, 1)]


def _icm_problem(form, res, S, dev, integer, seed=0):
    from newmsm_tpu_torch.ops import icm_bench
    if form == "group":
        return icm_bench.group_problem(S, res, dev, seed, integer)
    return icm_bench.pairwise_problem(res, form, dev, seed, integer)


@pytest.mark.cuda
@pytest.mark.parametrize("form,res,S", _ICM_CASES)
def test_icm_kernel_is_the_twin_bit_for_bit_on_integer_tables(cuda, form,
                                                              res, S):
    """Tables of small integers, where every float32 sum is exact: the
    kernel's descents and energies equal the plain version's bit for bit
    (padded incidence rows included: the ico grids' degree-5 vertices and
    the group's uneven pair incidence), and two launches repeat each
    other."""
    from newmsm_tpu_torch.ops import icm, icm_bench
    p = _icm_problem(form, res, S, cuda, integer=True)
    assert (p[5].vert_tri < 0).any() or form == "p4"
    before = icm.SEAM.tally["kernel"]
    got = icm_bench.compare(p)
    assert icm.SEAM.tally["kernel"] == before + 2
    assert got["xs_equal"] and got["es_equal"], got
    assert got["repeats"], got


@pytest.mark.cuda
@pytest.mark.parametrize("form,res,S", _ICM_CASES)
def test_icm_kernel_repeats_itself_on_real_valued_tables(cuda, form, res, S):
    """Gaussian tables: two launches on the same inputs give the same bits
    (no atomics), and the kernel's energies are those of its own
    descents (binary_energy of its xs, to 1e-5 relative)."""
    from newmsm_tpu_torch.ops import icm, icm_bench
    p = _icm_problem(form, res, S, cuda, integer=False, seed=1)
    x, u0, u1, t8, trip, _, _, p4, pairs = p
    assert icm_bench.compare(p)["repeats"]
    xs, es = icm_bench.kernel(p)
    want = icm.binary_energy(xs, u0, u1, t8, trip, p4, pairs).double()
    torch.testing.assert_close(es.double(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_icm_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    """Wrong dtype, a table on another device, a non-contiguous input: the
    wrapper raises before any launch. A launch the card refuses (a grid of
    zero starts) raises with its CUDA error."""
    from newmsm_tpu_torch.ops import icm
    x, u0, u1, t8, trip, tables, passes, p4, pairs = _icm_problem(
        "t8", 2, 1, cuda, integer=True)
    before = icm.SEAM.tally["kernel"]
    with pytest.raises(TypeError):
        icm.icm_binary(x, u0.double(), u1, t8, trip, tables, passes)
    with pytest.raises(ValueError):
        icm.icm_binary(x, u0.cpu(), u1, t8, trip, tables, passes)
    with pytest.raises(ValueError):
        icm.icm_binary(x, u0, u1, t8.t().contiguous().t(), trip, tables,
                       passes)
    assert icm.SEAM.tally["kernel"] == before
    es = torch.empty(0, dtype=torch.float32, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        icm.launch(x[:0], es, u0, u1, t8, trip, tables, passes)


def _recorded_moves(monkeypatch):
    """Every icm_binary call of a run, checked as it happens: the kernel's
    chosen start (first minimum) against the plain version's from the
    same starts and tables, on the card."""
    from newmsm_tpu_torch.ops import icm, icm_bench
    moves = []
    orig = icm.icm_binary

    def spy(x, *rest):
        problem = (x.clone(), *rest)
        xs, es = orig(x, *rest)
        xt, et = icm_bench.twin(problem)
        ik, it = int(torch.argmin(es)), int(torch.argmin(et))
        e_k, e_t = float(es[ik]), float(et[it])
        moves.append({"nodes": int(x.shape[1]),
                      "same_x": bool(torch.equal(xs[ik], xt[it])),
                      "rel": abs(e_k - e_t) / max(abs(e_t), 1e-30)})
        return xs, es
    monkeypatch.setattr(icm, "icm_binary", spy)
    return moves


def _assert_moves_agree(moves, nodes):
    """The chosen x equals the plain version's on at least 99 % of the
    moves at `nodes`, the chosen energy within 1e-5 relative on every
    move."""
    last = [m for m in moves if m["nodes"] == nodes]
    assert last, sorted({m["nodes"] for m in moves})
    same = np.mean([m["same_x"] for m in last])
    worst = max(m["rel"] for m in moves)
    assert same >= 0.99, (same, len(last))
    assert worst <= 1e-5, worst


_ICO4_STRAIN = """\
--simval=2,2
--sigma_in=2,1
--sigma_ref=2,1
--lambda=0.2,0.2
--it=1,2
--opt=DISCRETE,DISCRETE
--CPgrid=3,4
--SGgrid=5,6
--datagrid=5,6
--regoption=3
--regexp=2
--dopt=HOCR
--VN
--k_exponent=2
--bulkmod=1.6
--shearmod=0.4
--rescaleL
"""


@pytest.mark.cuda
def test_icm_kernel_on_the_moves_of_a_real_ico4_strain_level(
        cuda, tmp_path, monkeypatch):
    """register_dataset on an ico-6 synthetic subject, the strain recipe's
    last two discrete levels (CP ico-3, ico-4): every fusion move's kernel
    result against the plain version's on the move's own tables."""
    from newmsm_tpu_torch.eval.synth import synth_cohort
    from newmsm_tpu_torch.ops import icm
    from newmsm_tpu_torch.pipelines.cohort import register_dataset
    moves = _recorded_moves(monkeypatch)
    conf = tmp_path / "strain.conf"
    conf.write_text(_ICO4_STRAIN)
    _, datasets, template_data = synth_cohort(6, 1, seed=0)
    before = icm.SEAM.tally["kernel"]
    res = register_dataset(["s"], Mesh.from_icosphere(6), template_data,
                           str(conf), {"s": datasets[0]},
                           outdir=str(tmp_path) + "/", device=cuda)
    assert not res.failed, res.failed
    assert icm.SEAM.tally["kernel"] - before == len(moves) > 0
    _assert_moves_agree(moves, 2562)


_GROUP_S8 = """\
--simval=2,2,2
--sigma_in=0,0,0
--sigma_ref=0,0,0
--lambda=0.2,0.2,0.2
--it=1,1,1
--opt=DISCRETE,DISCRETE,DISCRETE
--CPgrid=2,3,4
--SGgrid=4,5,6
--datagrid=4,5,6
--regoption=3
--regexp=2
--dopt=HOCR
--k_exponent=2
--bulkmod=1.6
--shearmod=0.4
"""


@pytest.mark.cuda
def test_icm_kernel_on_the_alpha_steps_of_a_real_group_level(
        cuda, tmp_path, monkeypatch):
    """run_gmsm on 8 ico-6 synthetic subjects, the gMSM tutorial recipe
    at one iteration a level: every alpha step's kernel result against
    the plain version's on the step's own tables (N = 8 x 2,562 at the
    last level)."""
    from newmsm_tpu_torch.eval.synth import synth_cohort
    from newmsm_tpu_torch.pipelines.gmsm import run_gmsm
    moves = _recorded_moves(monkeypatch)
    conf = tmp_path / "group.conf"
    conf.write_text(_GROUP_S8)
    meshes, datasets, _ = synth_cohort(6, 8, seed=0)
    template = Mesh.from_icosphere(6)
    template.true_rescale(100.0)
    monkeypatch.chdir(tmp_path)
    run_gmsm(meshes, datasets, template, str(conf), device=cuda)
    _assert_moves_agree(moves, 8 * 2562)


# K3 (csrc/rigid_cost.cu) against its plain version, ops/rigid.py::
# rigid_terms_twin: (res, channels, simval, problem options). AFFINE's
# shape (ico-5, D = 2, the cosine), D = 10 in both similarities, N != Nt
# with the plain version's ragged last chunk, every source on a target
# (dist2 == 0 left out), empty neighbourhoods (wsum == 0), zero data
# columns (cosine denominator 0). Tolerances: ops/rigid_bench.py (JP_RTOL,
# TOTAL_RTOL: the order of the float32 sums; a gap beyond them only where
# a target within GATE_ULPS of the gate, moved across it, explains it).
_RIGID_CASES = [
    (5, 2, 2, {}), (5, 10, 1, {}), (5, 10, 2, {}),
    (5, 2, 2, {"n_src": 2 * 2048 + 2}), (5, 2, 2, {"degrees": 0.0}),
    (4, 2, 2, {"northern_targets": True}), (4, 3, 2, {"zero_columns": True}),
    (4, 3, 1, {"zero_columns": True}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("res,channels,simval,opts", _RIGID_CASES)
def test_rigid_kernel_matches_its_twin_and_repeats_its_bits(cuda, res,
                                                            channels, simval,
                                                            opts):
    """Each source's jp and the total within the stated tolerances of the
    plain version on the card; two calls give the same bits; one launch a
    call."""
    from newmsm_tpu_torch.ops import rigid, rigid_bench
    p = rigid_bench.problem(res, channels, simval, cuda, **opts)
    before = rigid.SEAM.tally["kernel"]
    got = rigid_bench.compare(p)
    assert rigid.SEAM.tally["kernel"] == before + 2
    assert got["repeats"], got
    assert got["unexplained"] == 0, got
    assert got["total_gap"] <= rigid_bench.TOTAL_RTOL, got
    assert got["ok"], got
    if opts.get("northern_targets"):
        assert got["empty_kernel"] == got["empty_twin"] > 0, got


@pytest.mark.cuda
def test_rigid_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    """Wrong dtype, a tensor on another device, a non-contiguous input,
    columns that do not match, another D: the wrapper raises before any
    launch. A launch the card refuses (no sources: a grid of zero blocks)
    raises with its CUDA error."""
    from newmsm_tpu_torch.ops import rigid, rigid_bench
    rot, src, tgt, tdat, cos_ang, sigma, simval = rigid_bench.problem(
        3, 2, 2, cuda)
    rest = (cos_ang, sigma, simval)
    before = rigid.SEAM.tally["kernel"]
    with pytest.raises(TypeError):
        rigid.rigid_terms(rot.double(), src, tgt, tdat, *rest)
    with pytest.raises(ValueError):
        rigid.rigid_terms(rot, src.cpu(), tgt, tdat, *rest)
    with pytest.raises(ValueError):
        rigid.rigid_terms(rot, src.t().contiguous().t(), tgt, tdat, *rest)
    with pytest.raises(ValueError):
        rigid.rigid_terms(rot, src[:, :-1].contiguous(), tgt, tdat, *rest)
    with pytest.raises(ValueError):
        rigid.rigid_terms(rot, src, tgt, tdat[:1].contiguous(), *rest)
    assert rigid.SEAM.tally["kernel"] == before
    out = torch.empty(1, dtype=torch.float32, device=cuda)
    scratch = torch.empty(16, dtype=torch.float32, device=cuda)
    ticket = torch.empty(1, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        rigid.launch(rot[:0], src[:, :0], tgt, tdat, cos_ang,
                     2 * sigma * sigma, simval, scratch, ticket, out[:0], out)


@pytest.mark.cuda
def test_rigid_align_through_the_kernel_is_rigid_align_through_its_twin(
        cuda, monkeypatch):
    """rigid_align on the card at ico-4, data turned by 10 degrees: through
    K3, every cost evaluation one `rigid.kernel` count and one launch;
    through the plain version, the same final cost to rtol 1e-4 and
    coordinates to 1e-2 at RAD 100 (the tolerances that hold the port's
    alignment to the JAX package's)."""
    from newmsm_tpu_torch import trace
    from newmsm_tpu_torch.ops import rigid, rigid_bench
    from newmsm_tpu_torch.reg import rigid as TR
    from newmsm_tpu_torch.reg.config import RegConfig
    from newmsm_tpu_torch.reg.featurespace import Featurespace
    _, src, tgt, tdat, cos_ang, sigma, _ = rigid_bench.problem(4, 2, 2, cuda)
    sphere = Mesh.from_icosphere(4)
    feat = Featurespace(data=[src.double().cpu().numpy(),
                              tdat.double().cpu().numpy()],
                        excl=[None, None])

    def align():
        with trace.run(None, cuda, on=True):
            with trace.span("affine") as span:
                out = TR.rigid_align(sphere, sphere, feat, RegConfig(),
                                     iters=10, simval=2, device=cuda)
        return out, span.counters

    before = rigid.SEAM.tally["kernel"]
    out_k, c = align()
    launched = rigid.SEAM.tally["kernel"] - before
    assert c["rigid.kernel"] == c["cost_evals"] == launched
    assert "rigid.twin" not in c
    monkeypatch.setattr(rigid, "rigid_terms", rigid.rigid_terms_twin)
    out_t, c_t = align()
    assert rigid.SEAM.tally["kernel"] - before == c["cost_evals"]
    np.testing.assert_allclose(out_k.coords, out_t.coords, atol=1e-2)

    def cost(mesh):
        rot = torch.as_tensor(mesh.coords, dtype=torch.float32).to(cuda)
        return float(rigid.rigid_terms_twin(rot, src, tgt, tdat, cos_ang,
                                            sigma, 2)[0])
    np.testing.assert_allclose(cost(out_k), cost(out_t), rtol=1e-4)
    assert cost(out_k) > cost(sphere)
