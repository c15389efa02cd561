"""Rigid neighbourhood cost of AFFINE: the wrapper of the hand-written
CUDA kernel csrc/rigid_cost.cu (K3: a scan and a combine kernel), which
replaces no TPU kernel (the JAX package runs the cost as XLA ops), and its
plain PyTorch version, the twin `rigid_terms_twin`. `rigid_terms`, each
rotated source's weighted neighbourhood similarity jp and their total,
picks one by device (ops/_build.py, `Kernel.run`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core import spherical as sph
from . import _build

SOURCE = "rigid_cost.cu"
KERNEL = "rigid_scan_kernel"      # the scan, most of a launch's time
# most targets a call takes: the scan grid has one row of blocks a tile of
# 128 targets (the kernel's kTile), and a grid has at most 65,535 rows
MAX_TARGETS = 65535 * 128
P, I, F = _build.PTR, _build.INT, _build.FLOAT
SEAM = _build.Kernel("rigid", SOURCE, "rigid_terms", "k3.load", {
    "rigid_cost_launch": ([P, P, P, P, I, I, I, F, F, I, P, P, P, P, P], I),
    "rigid_cost_layout": ([I, I, ctypes.POINTER(I), ctypes.POINTER(I),
                           ctypes.POINTER(_build.LONG)], None)})


def rigid_terms_twin(rot, src_data_c, tgt_coords, tgt_data_c,
                     cos_ang: float, min_sigma: float, simval: int,
                     chunk: int = 2048):
    """The plain version, on any device: (total 0-d, jp (N,)), each rotated
    source's weighted neighbourhood similarity jp computed a chunk of
    `chunk` sources at a time, and the total the sum of the chunks' sums
    in chunk order."""
    tgt_unit = tgt_coords / torch.linalg.norm(tgt_coords, dim=1, keepdim=True)
    src_norm = torch.linalg.norm(src_data_c, dim=0)
    tgt_norm = torch.linalg.norm(tgt_data_c, dim=0)
    total = torch.zeros((), dtype=rot.dtype, device=rot.device)
    jps = []
    for s in range(0, rot.shape[0], chunk):
        rc = rot[s:s + chunk]
        sn = src_norm[s:s + chunk]
        sd = src_data_c[:, s:s + chunk]
        unit = rc / torch.linalg.norm(rc, dim=1, keepdim=True)
        nbh = (unit @ tgt_unit.T) >= cos_ang                    # (c,Nt)

        # tangent-plane offsets of the targets around the radial point (the
        # source's own offset is zero) (WLS_simgradient,
        # rigid_costfunction.cpp:60-85)
        e1, e2 = sph.vertex_tangent_basis(unit)
        diff = tgt_coords[None, :, :] - rc[:, None, :]
        d1 = torch.einsum("cnk,ck->cn", diff, e1)
        d2 = torch.einsum("cnk,ck->cn", diff, e2)
        dist2 = d1 ** 2 + d2 ** 2
        w = torch.exp(-dist2 / (2.0 * min_sigma * min_sigma))
        w = torch.where((dist2 > 0) & nbh, w, torch.zeros_like(w))

        ab = sd.T @ tgt_data_c                                  # (c,Nt)
        if simval == 1:
            # -SSD(i,j) = -sqrt(sum_d (a-b)^2)/D (similarities.cpp:89-103)
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
        jps.append(jp)
    return total, torch.cat(jps)


@functools.lru_cache(maxsize=None)
def scratch_floats(n: int, nt: int) -> int:
    """Floats of scratch a launch needs for n sources and nt targets (the
    kernel's own layout: partials of every target slice, block sums)."""
    slices, blocks = ctypes.c_int(), ctypes.c_int()
    floats = ctypes.c_longlong()
    SEAM.library().rigid_cost_layout(n, nt, ctypes.byref(slices),
                                     ctypes.byref(blocks),
                                     ctypes.byref(floats))
    return floats.value


def check(rot, src_data_c, tgt_coords, tgt_data_c) -> None:
    """Raise unless the kernel takes these arguments: rot (N,3), src_data_c
    (D,N), tgt_coords (Nt,3), tgt_data_c (D,Nt), float32, contiguous, on
    rot's device, with N, Nt, D >= 1, N < 2^31 and Nt <= MAX_TARGETS.
    Reads no device value."""
    for name, t, cols in (("rot", rot, 3), ("src_data_c", src_data_c, None),
                          ("tgt_coords", tgt_coords, 3),
                          ("tgt_data_c", tgt_data_c, None)):
        SEAM.need(name, t, torch.float32, rot.device, 2, cols)
    if rot.shape[0] < 1 or tgt_coords.shape[0] < 1:
        raise ValueError(f"rigid_cost: no sources ({rot.shape[0]}) or no "
                         f"targets ({tgt_coords.shape[0]})")
    D = src_data_c.shape[0]
    if D < 1 or tgt_data_c.shape[0] != D:
        raise ValueError(f"rigid_cost: src_data_c and tgt_data_c must have "
                         f"the same D >= 1 rows, got {D} and "
                         f"{tgt_data_c.shape[0]}")
    if src_data_c.shape[1] != rot.shape[0]:
        raise ValueError(f"rigid_cost: src_data_c has {src_data_c.shape[1]}"
                         f" columns, rot {rot.shape[0]} points")
    if tgt_data_c.shape[1] != tgt_coords.shape[0]:
        raise ValueError(f"rigid_cost: tgt_data_c has {tgt_data_c.shape[1]}"
                         f" columns, tgt_coords {tgt_coords.shape[0]} points")
    if rot.shape[0] >= 2 ** 31 or tgt_coords.shape[0] > MAX_TARGETS:
        raise ValueError(f"rigid_cost: at most 2^31 - 1 sources and "
                         f"{MAX_TARGETS} targets, got {rot.shape[0]} and "
                         f"{tgt_coords.shape[0]}")


def launch(rot, src_data_c, tgt_coords, tgt_data_c, cos_ang: float,
           two_sigma2: float, simval: int, scratch, ticket, jp,
           total) -> None:
    """One unchecked call on rot's device: jp (N,) and total (1,) are
    overwritten; scratch holds scratch_floats(N, Nt) float32, ticket one
    int32. Does not count (`rigid_terms` does)."""
    SEAM.call("rigid_cost_launch", rot.device, rot.data_ptr(),
              src_data_c.data_ptr(), tgt_coords.data_ptr(),
              tgt_data_c.data_ptr(), rot.shape[0], tgt_coords.shape[0],
              src_data_c.shape[0], cos_ang, two_sigma2, int(simval),
              scratch.data_ptr(), ticket.data_ptr(), jp.data_ptr(),
              total.data_ptr())


def _kernel(rot, src_data_c, tgt_coords, tgt_data_c, cos_ang: float,
            min_sigma: float, simval: int):
    check(rot, src_data_c, tgt_coords, tgt_data_c)
    n, nt = rot.shape[0], tgt_coords.shape[0]
    out = torch.empty(n + 1, dtype=torch.float32, device=rot.device)
    scratch = torch.empty(scratch_floats(n, nt), dtype=torch.float32,
                          device=rot.device)
    ticket = torch.empty(1, dtype=torch.int32, device=rot.device)
    launch(rot, src_data_c, tgt_coords, tgt_data_c, cos_ang,
           2.0 * min_sigma * min_sigma, simval, scratch, ticket, out[1:],
           out[:1])
    return out[0], out[1:]


def rigid_terms(rot, src_data_c, tgt_coords, tgt_data_c, cos_ang: float,
                min_sigma: float, simval: int):
    """The rigid cost of rotated source points: (total 0-d, jp (N,)),
    float32. No host sync on the card."""
    return SEAM.run(rot, rigid_terms_twin, _kernel, rot, src_data_c,
                    tgt_coords, tgt_data_c, cos_ang, min_sigma, simval)
