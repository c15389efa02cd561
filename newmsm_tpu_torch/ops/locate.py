"""Pristine-icosphere locate + barycentric weights: the wrapper of the
hand-written CUDA kernel csrc/locate_bary.cu (the port of the Pallas kernel
newmsm_tpu/ops/pallas_locate.py) and its plain PyTorch version.

`locate_bary` takes CPU tensors to the plain version (the twin in
ops/nearest.py) and launches the kernel on CUDA tensors; anything else
raises. There is no fallback from the kernel to the twin: the comparison of
the two runs as a phase of chip_smoke.py, which fails on a mismatch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import nearest as _nst

SOURCE = "locate_bary.cu"
LAUNCHES = 0        # kernel launches since the last reset (plain int)


def locate_bary_reference(px, py, pz, res: int):
    """Plain PyTorch version: normalise, descend, weigh.
    Returns (fid int32, w0, w1, w2), shaped like px."""
    inv = torch.rsqrt(px * px + py * py + pz * pz)
    u = (px * inv, py * inv, pz * inv)
    fid, va, vb, vc = _nst._locate_pristine_soa(*u, res)
    w0, w1, w2 = _nst._bary_weights_soa(u, va, vb, vc)
    return fid.to(torch.int32), w0, w1, w2


@functools.lru_cache(maxsize=None)
def _library():
    from ._build import load
    lib = load(SOURCE)
    fn = lib.locate_bary_launch
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_int, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel_tables(device: torch.device) -> torch.Tensor:
    """Base corners then inward normals, (20,3,3) each, as one flat f32
    device tensor (the kernel's `tables` argument)."""
    bc, bn = _nst._base_tables_on(device)
    return torch.cat([bc.reshape(-1), bn.reshape(-1)]).contiguous()


def locate_bary(px, py, pz, res: int):
    """(fid int32, w0, w1, w2) of each query point (any radius) on the
    pristine level-`res` icosphere, shaped like px; weights in face vertex
    order."""
    global LAUNCHES
    dev = px.device
    if dev.type == "cpu":
        return locate_bary_reference(px, py, pz, res)
    if dev.type != "cuda":
        raise ValueError(f"locate_bary: unsupported device {dev}")
    for name, t in (("px", px), ("py", py), ("pz", pz)):
        if t.dtype != torch.float32:
            raise TypeError(f"locate_bary: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != dev or t.shape != px.shape:
            raise ValueError(f"locate_bary: {name} must match px in device "
                             "and shape")
        if not t.is_contiguous():
            raise ValueError(f"locate_bary: {name} must be contiguous")
    if not 0 <= int(res) <= 12:
        raise ValueError(f"locate_bary: resolution {res} out of range")
    launch = _library()
    tables = _kernel_tables(dev)
    fid = torch.empty(px.shape, dtype=torch.int32, device=dev)
    w0, w1, w2 = (torch.empty_like(px) for _ in range(3))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(px.data_ptr(), py.data_ptr(), pz.data_ptr(), px.numel(),
                    int(res), tables.data_ptr(), fid.data_ptr(),
                    w0.data_ptr(), w1.data_ptr(), w2.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"locate_bary kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return fid, w0, w1, w2
