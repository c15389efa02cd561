"""AFFINE's rigid cost (newmsm_tpu_torch/reg/rigid.py) on the CPU: CPU
tensors run the plain version (the twin, in ops/rigid.py beside the
kernel's wrapper), bit for bit the cost as it was written before the
hand-written kernel K3 (csrc/rigid_cost.cu) took the card's path; the
wrapper refuses what the kernel does not take without reading a device
value, and never falls back to the plain version. The kernel itself is compared with the plain version on the card
(tests/test_torch_cuda.py)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from newmsm_tpu_torch import trace
from newmsm_tpu_torch.core import spherical as sph
from newmsm_tpu_torch.core.mesh import Mesh
from newmsm_tpu_torch.ops import _build
from newmsm_tpu_torch.ops import rigid as K3
from newmsm_tpu_torch.ops import rigid_bench
from newmsm_tpu_torch.reg import rigid as TR
from newmsm_tpu_torch.reg.config import RegConfig
from newmsm_tpu_torch.reg.featurespace import Featurespace


def _cost_before_k3(angles, src_coords, src_data_c, tgt_coords, tgt_data_c,
                    cos_ang, min_sigma, simval, chunk=2048):
    """reg/rigid.py::rigid_cost as it stood before K3, verbatim."""
    rot = sph.apply_euler(src_coords, angles[0], angles[1], angles[2])
    tgt_unit = tgt_coords / torch.linalg.norm(tgt_coords, dim=1, keepdim=True)
    src_norm = torch.linalg.norm(src_data_c, dim=0)
    tgt_norm = torch.linalg.norm(tgt_data_c, dim=0)

    total = torch.zeros((), dtype=src_coords.dtype, device=src_coords.device)
    for s in range(0, rot.shape[0], chunk):
        rc = rot[s:s + chunk]
        sn = src_norm[s:s + chunk]
        sd = src_data_c[:, s:s + chunk]
        unit = rc / torch.linalg.norm(rc, dim=1, keepdim=True)
        nbh = (unit @ tgt_unit.T) >= cos_ang                    # (c,Nt)
        e1, e2 = sph.vertex_tangent_basis(unit)
        diff = tgt_coords[None, :, :] - rc[:, None, :]
        d1 = torch.einsum("cnk,ck->cn", diff, e1)
        d2 = torch.einsum("cnk,ck->cn", diff, e2)
        dist2 = d1 ** 2 + d2 ** 2
        w = torch.exp(-dist2 / (2.0 * min_sigma * min_sigma))
        w = torch.where((dist2 > 0) & nbh, w, torch.zeros_like(w))

        ab = sd.T @ tgt_data_c                                  # (c,Nt)
        if simval == 1:
            a2 = (sd * sd).sum(0)[:, None]
            b2 = (tgt_data_c * tgt_data_c).sum(0)[None, :]
            simm = -torch.sqrt(torch.clamp(a2 + b2 - 2 * ab, min=0.0)) / sd.shape[0]
        else:
            denom = sn[:, None] * tgt_norm[None, :]
            simm = torch.where(denom > 0, ab / torch.where(
                denom > 0, denom, torch.ones_like(denom)), torch.zeros_like(ab))
        wsum = w.sum(1)
        jp = torch.where(wsum > 0, (w * simm).sum(1) / torch.where(
            wsum > 0, wsum, torch.ones_like(wsum)), torch.zeros_like(wsum))
        total = total + jp.sum()
    return total


# (channels, simval, problem options): the cosine and the SSD branch, one
# and several channels, a ragged last chunk with N != Nt, sources on the
# targets, empty neighbourhoods, zero data columns
_CPU_CASES = [
    (2, 2, {}), (2, 1, {}), (1, 2, {}), (3, 1, {}),
    (2, 2, {"n_src": 2 * 300 + 2}), (3, 1, {"degrees": 0.0}),
    (2, 2, {"northern_targets": True}), (3, 2, {"zero_columns": True}),
    (3, 1, {"zero_columns": True}),
]


@pytest.mark.parametrize("channels,simval,opts", _CPU_CASES)
def test_rigid_cost_on_cpu_is_the_cost_before_k3_bit_for_bit(channels,
                                                             simval, opts):
    """CPU tensors take the plain version, whose total (and the jp the
    benchmark module sums from its chunks) is the old body's to the bit,
    at angles of zero and away from zero, in one chunk and in chunks of
    300 sources."""
    p = rigid_bench.problem(3, channels, simval, "cpu", seed=4, **opts)
    rot, src, tgt, tdat, cos_ang, sigma, _ = p
    for angles in (torch.zeros(3), torch.tensor([0.02, -0.01, 0.03])):
        args = (angles, rot, src, tgt, tdat, cos_ang, sigma, simval)
        got = TR.rigid_cost(*args)
        assert got.dtype == torch.float32 and got.dim() == 0
        want = _cost_before_k3(*args)
        assert torch.equal(got, want), (float(got), float(want))
        rot_a = sph.apply_euler(rot, *angles)
        got = K3.rigid_terms_twin(rot_a, src, tgt, tdat, cos_ang, sigma,
                                  simval, chunk=300)[0]
        want = _cost_before_k3(*args, chunk=300)
        assert torch.equal(got, want), (float(got), float(want))
    total, jp = K3.rigid_terms_twin(*p)
    assert torch.equal(total, _cost_before_k3(torch.zeros(3), *p))
    assert jp.shape == (rot.shape[0],)
    if opts.get("northern_targets"):
        south = rot[:, 2] < -70       # farther from z = 0 than the gate
        assert south.any() and (jp[south] == 0).all()


_BLOCK = 128    # sources a scan block of K3 (kSources, csrc/rigid_cost.cu)


def _gate_tie_problem():
    """An ico-3 problem with 3 channels (642 sources: five scan blocks and
    two sources in a partial sixth) whose gate passes, for the last source, its second
    nearest target at exactly cos_ang in the plain version's own product,
    so that target weighs much in its jp; and the last source's index."""
    rot, src, tgt, tdat, _, sigma, simval = rigid_bench.problem(3, 3, 2,
                                                                "cpu")
    unit = rot / torch.linalg.norm(rot, dim=1, keepdim=True)
    tgt_unit = tgt / torch.linalg.norm(tgt, dim=1, keepdim=True)
    i = rot.shape[0] - 1
    dots = (unit @ tgt_unit.T)[i]
    cos_ang = float(dots.sort(descending=True).values[1])
    return (rot, src, tgt, tdat, cos_ang, sigma, simval), i


def _faulty(fault, i):
    """The plain version standing in for K3, with `fault` in the sources
    of the partial last scan block (or in the total alone); the jp of a
    fault summed into the total, as a kernel would."""
    def run(p):
        if fault.startswith("gate_tie"):
            # the kernel's product puts the edge target just outside
            cos = float(np.nextafter(np.float32(p[4]), np.float32(1)))
            p = p[:4] + (cos,) + p[5:]
        total, jp = K3.rigid_terms_twin(*p)
        jp = jp.clone()
        n = jp.shape[0]
        tail = torch.arange(n - n % _BLOCK, n)
        if fault == "wrong_column":
            jp[tail] = jp[tail - _BLOCK]
        elif fault == "scaled":
            jp[tail] = jp[tail] * 1.001
        elif fault == "zeroed":
            jp[tail] = 0.0
        elif fault == "gate_tie_wrong":
            jp[i] = jp[i] + 0.01
        if fault == "total_only":
            total = total + 1e-4 * jp.abs().sum()
        elif fault not in ("none", "gate_tie"):
            total = jp.sum()
        return total, jp
    return run


@pytest.mark.parametrize("fault,ok", [
    ("none", True), ("gate_tie", True), ("wrong_column", False),
    ("scaled", False), ("zeroed", False), ("total_only", False),
    ("gate_tie_wrong", False)])
def test_rigid_comparison_fails_a_kernel_wrong_in_its_last_partial_block(
        monkeypatch, fault, ok):
    """ops/rigid_bench.py::compare, with the plain version standing in for
    K3: it passes the plain version itself, and a gate that differs only
    in a target at the gate's edge (a tie, explained by moving that target
    across the gate); it fails a kernel whose two sources of the partial
    last scan block hold another block's values, values 0.1 % off or 0,
    a total alone off by 1e-4 of the sum of |jp|, and a tie source whose
    jp neither gate gives."""
    p, i = _gate_tie_problem()
    assert p[0].shape[0] % _BLOCK == 2
    monkeypatch.setattr(rigid_bench, "kernel", _faulty(fault, i))
    got = rigid_bench.compare(p)
    assert got["ok"] is ok, got
    assert got["repeats"], got
    if fault == "gate_tie":
        assert got["ties"] >= 1 and got["unexplained"] == 0, got
    elif fault in ("wrong_column", "scaled", "zeroed"):
        assert got["unexplained"] == 2, got
    elif fault == "total_only":
        assert got["unexplained"] == 0, got
        assert got["total_gap"] > rigid_bench.TOTAL_RTOL, got
    elif fault == "gate_tie_wrong":
        assert got["unexplained"] == 1, got


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _good(n=40, nt=30, d=2):
    return [_meta(n, 3), _meta(d, n), _meta(nt, 3), _meta(d, nt)]


def _bad(case):
    args = _good()
    if case == "dtype":
        args[1] = _meta(2, 40, dtype=torch.float64)
    elif case == "rot_width":
        args[0] = _meta(40, 2)
    elif case == "rot_rank":
        args[0] = _meta(120)
    elif case == "tgt_width":
        args[2] = _meta(30, 4)
    elif case == "no_sources":
        args[0], args[1] = _meta(0, 3), _meta(2, 0)
    elif case == "channels":
        args[3] = _meta(3, 30)
    elif case == "no_channels":
        args[1], args[3] = _meta(0, 40), _meta(0, 30)
    elif case == "src_columns":
        args[1] = _meta(2, 41)
    elif case == "tgt_columns":
        args[3] = _meta(2, 29)
    elif case == "contiguity":
        args[1] = _meta(40, 2).t()
    elif case == "device":
        args[2] = torch.zeros(30, 3)
    elif case == "too_many_targets":
        nt = K3.MAX_TARGETS + 1
        args[2], args[3] = _meta(nt, 3), _meta(2, nt)
    return args


@pytest.mark.parametrize("case,error", [
    ("dtype", TypeError), ("rot_width", ValueError), ("rot_rank", ValueError),
    ("tgt_width", ValueError), ("no_sources", ValueError),
    ("channels", ValueError), ("no_channels", ValueError),
    ("src_columns", ValueError), ("tgt_columns", ValueError),
    ("contiguity", ValueError), ("device", ValueError),
    ("too_many_targets", ValueError)])
def test_rigid_check_refuses_without_reading_a_device_value(case, error):
    """ops/rigid.py::check on meta tensors, which hold no values: a wrong
    dtype, shape, D or contiguity, a tensor on another device, or more
    targets than the kernel's grid takes, raises; the good arguments
    pass."""
    K3.check(*_good())
    with pytest.raises(error):
        K3.check(*_bad(case))


def test_k3_refuses_cpu_and_meta_tensors_without_a_fallback():
    """The kernel's entry runs the twin on CPU tensors and the kernel on
    CUDA tensors, and rigid_cost sends every tensor to it: a meta tensor
    raises there rather than running the plain version. Nothing is
    counted."""
    p = rigid_bench.problem(2, 2, 2, "cpu")
    total, jp = K3.rigid_terms(*p)
    want = K3.rigid_terms_twin(*p)
    assert torch.equal(total, want[0]) and torch.equal(jp, want[1])
    before = dict(K3.SEAM.tally)
    rot, src, tgt, tdat, cos_ang, sigma, simval = p
    meta = [t.to("meta") for t in (rot, src, tgt, tdat)]
    with trace.run(None, "cpu", on=True) as tracer:
        with trace.span("affine") as span:
            with pytest.raises(ValueError, match="unsupported device"):
                TR.rigid_cost(torch.zeros(3, device="meta"), meta[0], meta[1],
                              meta[2], meta[3], cos_ang, sigma, simval)
        assert tracer is not None
    assert "rigid.twin" not in span.counters
    assert "rigid.kernel" not in span.counters
    assert K3.SEAM.tally == before


def test_rigid_align_on_cpu_counts_one_twin_call_a_cost_evaluation():
    """rigid_align on the CPU under tracing: every cost evaluation is one
    `rigid.twin` count, none a `rigid.kernel`, and the source sphere
    moves."""
    _, src, _, tdat, _, _, _ = rigid_bench.problem(3, 2, 2, "cpu",
                                                   degrees=8.0)
    sphere = Mesh.from_icosphere(3)
    feat = Featurespace(data=[src.double().numpy(), tdat.double().numpy()],
                        excl=[None, None])
    with trace.run(None, "cpu", on=True):
        with trace.span("affine") as span:
            out = TR.rigid_align(sphere, sphere, feat, RegConfig(), iters=4,
                                 simval=2, device="cpu")
    c = span.counters
    assert c["cost_evals"] > 0
    assert c["rigid.twin"] == c["cost_evals"]
    assert "rigid.kernel" not in c
    assert not np.allclose(out.coords, sphere.coords)


def test_rigid_kernel_source_states_what_it_replaces_and_its_numerics():
    """csrc/rigid_cost.cu: a C interface (the launch and the scratch
    layout), the note that it replaces no TPU kernel, exact float32
    library calls (no fast-math intrinsics), and no float atomics (the
    one atomic is the combine's integer ticket), so a launch repeats its
    bits."""
    text = (_build.CSRC_DIR / K3.SOURCE).read_text()
    assert 'extern "C" int rigid_cost_launch' in text
    assert 'extern "C" void rigid_cost_layout' in text
    assert "Replaces no TPU kernel" in text
    assert f"{K3.KERNEL}(const Args a)" in text
    for fast in ("__expf", "__fdividef", "__frcp", "__fsqrt_r", "__powf"):
        assert fast not in text.replace("__fsqrt_rn", ""), fast
    assert text.count("atomicAdd(") == 1
    assert "atomicAdd(a.ticket, 1u)" in text
    assert "-use_fast_math" not in _build.NVCC_FLAGS
