"""Pristine-icosphere locate + barycentric weights: the wrapper of the
hand-written CUDA kernel csrc/locate_bary.cu (K1, the port of the Pallas
kernel newmsm_tpu/ops/pallas_locate.py) and its plain PyTorch version,
the twin `locate_bary_reference`. `locate_bary` picks one by device
(ops/_build.py, `Kernel.run`).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import trace
from . import _build
from . import nearest as _nst

SOURCE = "locate_bary.cu"
KERNEL = "locate_bary_kernel"     # name of the __global__ template
MAX_RES = 12                      # the kernel is instantiated for 0..MAX_RES
P, I = _build.PTR, _build.INT
SEAM = _build.Kernel("locate", SOURCE, "locate_bary", "k1.load", {
    "locate_bary_launch": ([P, P, P, _build.LONG, I, P, P, P, P, P, P], I),
    "locate_bary_resident_blocks": ([I], I),
    "locate_bary_set_tables": ([P], I)})


def locate_bary_reference(px, py, pz, res: int):
    """Plain PyTorch version: normalise, descend, weigh.
    Returns (fid int32, w0, w1, w2), shaped like px."""
    inv = torch.rsqrt(px * px + py * py + pz * pz)
    u = (px * inv, py * inv, pz * inv)
    fid, va, vb, vc = _nst._locate_pristine_soa(*u, res)
    w0, w1, w2 = _nst._bary_weights_soa(u, va, vb, vc)
    return fid.to(torch.int32), w0, w1, w2


def set_constant_tables(lib, device) -> None:
    """Copy the base-face normals into `device`'s constant memory of a
    built locate library, where its base-face scan reads them."""
    normals = np.ascontiguousarray(_nst._base_face_tables()[1], np.float32)
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
    set_constant_tables(SEAM.library(), device)
    bc, bn = _nst._base_tables_on(device)
    return torch.cat([bc.reshape(-1), bn.reshape(-1)]).contiguous()


def launch(px, py, pz, res: int, tables, fid, w0, w1, w2, lib=None) -> None:
    """One unchecked launch on px's device into preallocated outputs (of
    `lib`, a build of another source with this interface, when given).
    Does not count (`locate_bary` does)."""
    SEAM.call("locate_bary_launch", px.device, px.data_ptr(), py.data_ptr(),
              pz.data_ptr(), px.numel(), int(res), tables.data_ptr(),
              fid.data_ptr(), w0.data_ptr(), w1.data_ptr(), w2.data_ptr(),
              lib=lib)


def resident_blocks(res: int, device) -> int:
    """Blocks the level-`res` kernel's grid is capped at on `device`
    (occupancy API x SM count)."""
    with torch.cuda.device(device):
        n = SEAM.library().locate_bary_resident_blocks(int(res))
    if n <= 0:
        raise RuntimeError(f"locate_bary: no occupancy for res {res}")
    return n


def check(px, py, pz, res: int) -> None:
    """Raise unless the kernel takes these arguments: px, py, pz float32,
    contiguous, of one shape on px's device; 0 <= res <= MAX_RES."""
    for name, t in (("px", px), ("py", py), ("pz", pz)):
        SEAM.need(name, t, torch.float32, px.device)
        if t.shape != px.shape:
            raise ValueError(f"locate_bary: {name} must have px's shape "
                             f"{tuple(px.shape)}, got {tuple(t.shape)}")
    if not 0 <= int(res) <= MAX_RES:
        raise ValueError(f"locate_bary: resolution {res} out of range")


def _kernel(px, py, pz, res: int):
    check(px, py, pz, res)
    tables = kernel_tables(px.device)
    fid = torch.empty(px.shape, dtype=torch.int32, device=px.device)
    w0, w1, w2 = (torch.empty_like(px) for _ in range(3))
    launch(px, py, pz, res, tables, fid, w0, w1, w2)
    return fid, w0, w1, w2


def locate_bary(px, py, pz, res: int):
    """(fid int32, w0, w1, w2) of each query point (any radius) on the
    pristine level-`res` icosphere, shaped like px; weights in face vertex
    order."""
    return SEAM.run(px, locate_bary_reference, _kernel, px, py, pz, res)
