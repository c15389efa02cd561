"""Tests of newmsm_tpu_torch that need a CUDA card: the hand-written
locate kernel against its plain PyTorch version on the card (on the
sphere, off it, and at the size of a triclique call), and the MCMC colour
scatter and the face-patch scatter on the card against the CPU. They skip
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
