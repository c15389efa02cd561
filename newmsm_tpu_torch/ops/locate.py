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

import numpy as np
import torch

from .. import trace
from . import nearest as _nst

SOURCE = "locate_bary.cu"
KERNEL = "locate_bary_kernel"     # name of the __global__ template
MAX_RES = 12                      # the kernel is instantiated for 0..MAX_RES
LAUNCHES = 0        # kernel launches since the last reset (plain int)
LARGEST = 0         # most queries in one of those launches


def locate_bary_reference(px, py, pz, res: int):
    """Plain PyTorch version: normalise, descend, weigh.
    Returns (fid int32, w0, w1, w2), shaped like px."""
    inv = torch.rsqrt(px * px + py * py + pz * pz)
    u = (px * inv, py * inv, pz * inv)
    fid, va, vb, vc = _nst._locate_pristine_soa(*u, res)
    w0, w1, w2 = _nst._bary_weights_soa(u, va, vb, vc)
    return fid.to(torch.int32), w0, w1, w2


def bind(lib: ctypes.CDLL):
    """Declare the C interface of a built locate library; returns its
    launch function."""
    p = ctypes.c_void_p
    fn = lib.locate_bary_launch
    fn.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_int, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


@trace.cached()
def _library() -> ctypes.CDLL:
    from ._build import load
    lib = load(SOURCE, mark="k1.load")
    bind(lib)
    lib.locate_bary_resident_blocks.argtypes = [ctypes.c_int]
    lib.locate_bary_resident_blocks.restype = ctypes.c_int
    return lib


def set_constant_tables(lib: ctypes.CDLL, device) -> None:
    """Copy the base-face normals into `device`'s constant memory of a
    built locate library, where its base-face scan reads them."""
    normals = np.ascontiguousarray(_nst._base_face_tables()[1], np.float32)
    lib.locate_bary_set_tables.argtypes = [ctypes.c_void_p]
    lib.locate_bary_set_tables.restype = ctypes.c_int
    with torch.cuda.device(device):
        rc = lib.locate_bary_set_tables(normals.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"locate_bary: copying the base tables failed: "
                           f"CUDA error {rc}")


@trace.cached()
def kernel_tables(device: torch.device) -> torch.Tensor:
    """Base corners then inward normals, (20,3,3) each, as one flat f32
    device tensor (the kernel's `tables` argument, read per thread for the
    chosen face). The first call for a device also fills that device's
    constant memory (`set_constant_tables`)."""
    set_constant_tables(_library(), device)
    bc, bn = _nst._base_tables_on(device)
    return torch.cat([bc.reshape(-1), bn.reshape(-1)]).contiguous()


def launch(fn, px, py, pz, res: int, tables, fid, w0, w1, w2) -> None:
    """One unchecked launch of a bound launch function on px's device and
    PyTorch's current stream, into preallocated outputs; raises on a CUDA
    error. Does not count (`locate_bary` does)."""
    dev = px.device
    with torch.cuda.device(dev):
        rc = fn(px.data_ptr(), py.data_ptr(), pz.data_ptr(), px.numel(),
                int(res), tables.data_ptr(), fid.data_ptr(), w0.data_ptr(),
                w1.data_ptr(), w2.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"locate_bary kernel launch failed: CUDA error "
                           f"{rc}")


def resident_blocks(res: int, device) -> int:
    """Blocks the level-`res` kernel's grid is capped at on `device`
    (occupancy API x SM count)."""
    with torch.cuda.device(device):
        n = _library().locate_bary_resident_blocks(int(res))
    if n <= 0:
        raise RuntimeError(f"locate_bary: no occupancy for res {res}")
    return n


def locate_bary(px, py, pz, res: int):
    """(fid int32, w0, w1, w2) of each query point (any radius) on the
    pristine level-`res` icosphere, shaped like px; weights in face vertex
    order."""
    global LAUNCHES, LARGEST
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
    if not 0 <= int(res) <= MAX_RES:
        raise ValueError(f"locate_bary: resolution {res} out of range")
    fn = _library().locate_bary_launch
    tables = kernel_tables(dev)
    fid = torch.empty(px.shape, dtype=torch.int32, device=dev)
    w0, w1, w2 = (torch.empty_like(px) for _ in range(3))
    launch(fn, px, py, pz, res, tables, fid, w0, w1, w2)
    LAUNCHES += 1
    LARGEST = max(LARGEST, px.numel())
    return fid, w0, w1, w2
