"""Tests of newmsm_tpu_torch that need a CUDA card: the hand-written
locate kernel against its plain PyTorch version on the card. They skip
without one. The machine with the card has no JAX, so this file imports
none, and is run there without tests/conftest.py (which imports JAX):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from newmsm_tpu.core.icosphere import icosphere


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
