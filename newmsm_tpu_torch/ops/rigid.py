"""Rigid neighbourhood cost of AFFINE on the card: the wrapper of the
hand-written CUDA kernel csrc/rigid_cost.cu (K3), which replaces no TPU
kernel (the JAX package runs the cost as XLA ops).

`rigid_terms` computes, for rotated source points, what the plain version
reg/rigid.py::rigid_terms_twin (the twin) computes: each source's weighted
neighbourhood similarity jp and their total, in one call (a scan and a
combine kernel). `reg.rigid.rigid_cost` reaches it for CUDA tensors and
runs the twin for CPU tensors. Anything the kernel does not take raises
here: there is no fallback from the kernel to the twin. The comparison of
the two runs in tests/test_torch_cuda.py and in chip_smoke.py.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import trace

SOURCE = "rigid_cost.cu"
KERNEL = "rigid_scan_kernel"      # the scan, most of a launch's time
LAUNCHES = 0        # calls (cost evaluations) since the last reset (plain int)
# most targets a call takes: the scan grid has one row of blocks a tile of
# 128 targets (the kernel's kTile), and a grid has at most 65,535 rows
MAX_TARGETS = 65535 * 128


@trace.cached()
def library() -> ctypes.CDLL:
    """The built rigid-cost library, its functions declared."""
    from ._build import load
    lib = load(SOURCE, mark="k3.load")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rigid_cost_launch.argtypes = [p, p, p, p, i, i, i, f, f, i, p, p, p,
                                      p, p]
    lib.rigid_cost_launch.restype = ctypes.c_int
    lib.rigid_cost_layout.argtypes = [i, i, ctypes.POINTER(i),
                                      ctypes.POINTER(i),
                                      ctypes.POINTER(ctypes.c_longlong)]
    lib.rigid_cost_layout.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def scratch_floats(n: int, nt: int) -> int:
    """Floats of scratch a launch needs for n sources and nt targets (the
    kernel's own layout: partials of every target slice, block sums)."""
    slices, blocks = ctypes.c_int(), ctypes.c_int()
    floats = ctypes.c_longlong()
    library().rigid_cost_layout(n, nt, ctypes.byref(slices),
                                ctypes.byref(blocks), ctypes.byref(floats))
    return floats.value


def check(rot, src_data_c, tgt_coords, tgt_data_c) -> None:
    """Raise unless the kernel takes these arguments: rot (N,3), src_data_c
    (D,N), tgt_coords (Nt,3), tgt_data_c (D,Nt), float32, contiguous, on
    rot's device, with N, Nt, D >= 1, N < 2^31 and Nt <= MAX_TARGETS.
    Reads no device value."""
    dev = rot.device
    for name, t in (("rot", rot), ("src_data_c", src_data_c),
                    ("tgt_coords", tgt_coords), ("tgt_data_c", tgt_data_c)):
        if t.device != dev:
            raise ValueError(f"rigid_terms: {name} is on {t.device}, rot on "
                             f"{dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"rigid_terms: {name} must be float32, got "
                            f"{t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"rigid_terms: {name} must have 2 dimensions, "
                             f"got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"rigid_terms: {name} must be contiguous")
    for name, t in (("rot", rot), ("tgt_coords", tgt_coords)):
        if t.shape[1] != 3 or t.shape[0] < 1:
            raise ValueError(f"rigid_terms: {name} must be (M,3) with M >= "
                             f"1, got shape {tuple(t.shape)}")
    D = src_data_c.shape[0]
    if D < 1 or tgt_data_c.shape[0] != D:
        raise ValueError(f"rigid_terms: src_data_c and tgt_data_c must have "
                         f"the same D >= 1 rows, got {D} and "
                         f"{tgt_data_c.shape[0]}")
    if src_data_c.shape[1] != rot.shape[0]:
        raise ValueError(f"rigid_terms: src_data_c has {src_data_c.shape[1]}"
                         f" columns, rot {rot.shape[0]} points")
    if tgt_data_c.shape[1] != tgt_coords.shape[0]:
        raise ValueError(f"rigid_terms: tgt_data_c has {tgt_data_c.shape[1]}"
                         f" columns, tgt_coords {tgt_coords.shape[0]} points")
    if rot.shape[0] >= 2 ** 31 or tgt_coords.shape[0] > MAX_TARGETS:
        raise ValueError(f"rigid_terms: at most 2^31 - 1 sources and "
                         f"{MAX_TARGETS} targets, got {rot.shape[0]} and "
                         f"{tgt_coords.shape[0]}")


def launch(rot, src_data_c, tgt_coords, tgt_data_c, cos_ang: float,
           two_sigma2: float, simval: int, scratch, ticket, jp,
           total) -> None:
    """One unchecked call on rot's device and PyTorch's current stream:
    jp (N,) and total (1,) are overwritten; scratch holds
    scratch_floats(N, Nt) float32, ticket one int32. Raises on a CUDA
    error. Does not count (`rigid_terms` does)."""
    dev = rot.device
    with torch.cuda.device(dev):
        rc = library().rigid_cost_launch(
            rot.data_ptr(), src_data_c.data_ptr(), tgt_coords.data_ptr(),
            tgt_data_c.data_ptr(), rot.shape[0], tgt_coords.shape[0],
            src_data_c.shape[0], cos_ang, two_sigma2, int(simval),
            scratch.data_ptr(), ticket.data_ptr(), jp.data_ptr(),
            total.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rigid_cost kernel launch failed: CUDA error "
                           f"{rc}")


def rigid_terms(rot, src_data_c, tgt_coords, tgt_data_c, cos_ang: float,
                min_sigma: float, simval: int):
    """The rigid cost of rotated source points on the card: (total 0-d, jp
    (N,)), float32, what rigid_terms_twin gives. No host sync."""
    global LAUNCHES
    if rot.device.type != "cuda":
        raise ValueError(f"rigid_terms: unsupported device {rot.device}")
    check(rot, src_data_c, tgt_coords, tgt_data_c)
    n, nt = rot.shape[0], tgt_coords.shape[0]
    out = torch.empty(n + 1, dtype=torch.float32, device=rot.device)
    scratch = torch.empty(scratch_floats(n, nt), dtype=torch.float32,
                          device=rot.device)
    ticket = torch.empty(1, dtype=torch.int32, device=rot.device)
    launch(rot, src_data_c, tgt_coords, tgt_data_c, cos_ang,
           2.0 * min_sigma * min_sigma, simval, scratch, ticket, out[1:],
           out[:1])
    LAUNCHES += 1
    return out[0], out[1:]
