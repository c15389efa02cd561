"""Tests of newmsm_tpu_torch that need a CUDA card: the hand-written
locate kernel against its plain PyTorch version on the card (on the
sphere, off it, and at the size of a triclique call), the MCMC colour
scatter and the face-patch scatter on the card against the CPU, the
groupwise path's fusion tables and label maps on the card against the CPU,
and its subject-sharded fusion call on the card (a 1-rank NCCL group, two
gloo ranks sharing the card) against the one-device call. They skip
without one. The machine with the card has no JAX, so this file imports
neither JAX nor the JAX package, and is run there without tests/conftest.py
(which imports JAX):

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
    before = locate.LAUNCHES
    fid_k, *wk = locate.locate_bary(px, py, pz, res)
    fid_p, *wp = locate.locate_bary_reference(px, py, pz, res)
    torch.cuda.synchronize()
    assert locate.LAUNCHES == before + 1
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
    """On the card every label's reverse map is one kernel launch of N
    queries; against the plain version (the same function on the CPU): all
    entries within 1e-3, all but 1e-3 of them within 1e-4 (the kernel's
    ties against its twin are boundary ties, which move a ~0 weight)."""
    from newmsm_tpu_torch.eval.synth import smooth_sphere_warp
    from newmsm_tpu_torch.ops import locate, resample as rsp
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
        before = locate.LAUNCHES
        got[dev.type] = rsp.label_deformed_maps(
            f32(warped), f32(data), tabs.faces,
            torch.as_tensor(tri_idx.astype(np.int64)).to(dev),
            tabs.ring_faces, tabs.ring_verts, f32(sg.samples), f32(sg.centre),
            ttm, f32(tm.vertex_area()),
            cap=rsp._adaptive_cap(dg.nvertices, tm.nvertices)).cpu().numpy()
        launched = locate.LAUNCHES - before
        assert launched == (len(sg.samples) if dev.type == "cuda" else 0)
    err = np.abs(got["cuda"] - got["cpu"])
    assert err.max() < 1e-3, err.max()
    assert (err > 1e-4).mean() <= 1e-3, (err > 1e-4).sum()


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
