"""Spherical resampling: barycentric, adaptive barycentric, nearest
neighbour, geodesic smoothing and warp application.

Port of newmsm_tpu/ops/resample.py (resampler.cpp). Variable-length weight
maps become (Q, R) padded index/weight tables; the octree is ops.nearest.
Exclusion semantics are kept: nonzero mask == usable vertex, excluded
contributions are dropped without renormalising data weights, and the mask
is resampled alongside (resampler.cpp:30-70).

The mesh-level wrappers take numpy meshes (newmsm_tpu.core.mesh.Mesh) and
an explicit device, and return numpy meshes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from newmsm_tpu.core.mesh import Mesh

from .. import RAD
from ..core import spherical as sph
from .nearest import SearchTables, barycentric_coords, build_tables, closest_vertex


def _f32(a, device):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(device)


# --------------------------------------------------------------------------
# tensor-level kernels
# --------------------------------------------------------------------------

def apply_weights(idx, w, data):
    """out[:, q] = sum_j w[q,j] * data[:, idx[q,j]]; idx (Q,J), w (Q,J),
    data (D,N) -> (D,Q). Padding entries must carry w == 0."""
    gathered = data[:, idx.clamp(0, data.shape[1] - 1)]          # (D,Q,J)
    return (gathered * w[None]).sum(-1)


def adaptive_weights(in_coords, low_coords, in_tables: SearchTables,
                     low_tables: SearchTables, in_vareas, low_vareas,
                     excl_in=None, cap: int = 16):
    """Workbench ADAP_BARY_AREA weights (resampler.cpp:72-140).
    Returns (idx (Q,cap) int64 [-1 padded], w (Q,cap) f32) rows summing to
    1 (all-zero for rows gated out by the exclusion mask).

    The area correction is a scatter-add. It goes through
    index_put_(accumulate=True), which on CUDA sorts the indices and sums
    duplicates in a fixed order (index_add_ would use float atomics, whose
    order changes from run to run). It agrees with the JAX segment_sum to
    rounding, not bitwise."""
    Q = low_coords.shape[0]
    Nold = in_coords.shape[0]
    dev = in_coords.device

    fwd_idx, fwd_w = barycentric_coords(low_coords, in_tables)
    rev_idx, rev_w = barycentric_coords(in_coords, low_tables)

    # transpose the reverse map: rows keyed by low-mesh vertex
    tgt = rev_idx.reshape(-1)
    src = torch.arange(Nold, device=dev).repeat_interleave(3)
    wgt = rev_w.reshape(-1)
    order = torch.sort(tgt, stable=True).indices
    tgt_s, src_s, wgt_s = tgt[order], src[order], wgt[order]
    counts = torch.bincount(tgt_s, minlength=Q)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(tgt_s.shape[0], device=dev) - starts[tgt_s]
    keep = pos < cap                                  # beyond cap: dropped
    flat = (tgt_s * cap + pos)[keep]
    rr_idx = torch.full((Q * cap,), -1, dtype=torch.int64, device=dev)
    rr_w = torch.zeros((Q * cap,), dtype=wgt.dtype, device=dev)
    rr_idx[flat] = src_s[keep]
    rr_w[flat] = wgt_s[keep]
    rr_idx = rr_idx.reshape(Q, cap)
    rr_w = rr_w.reshape(Q, cap)

    # choose the denser map per row (resampler.cpp:105-109)
    use_rev = (counts > 3)[:, None]
    fwd_idx_p = torch.nn.functional.pad(fwd_idx, (0, cap - 3), value=-1)
    fwd_w_p = torch.nn.functional.pad(fwd_w, (0, cap - 3))
    idx = torch.where(use_rev, rr_idx, fwd_idx_p)
    w = torch.where(use_rev, rr_w, fwd_w_p)
    valid = idx >= 0

    # row gate: closest in-mesh vertex must be usable (resampler.cpp:102,123)
    if excl_in is not None:
        gate = excl_in[closest_vertex(low_coords, in_tables)] != 0
    else:
        gate = torch.ones((Q,), dtype=torch.bool, device=dev)

    # area correction (resampler.cpp:111-137)
    w = w * valid * gate[:, None] * low_vareas[:, None]
    cidx = idx.clamp(0, Nold - 1)
    # real entries only: the clamped -1 padding would pile every padded
    # slot onto vertex 0, whose duplicates the sorted CUDA sum adds
    # serially (37 ms a call at ico-6, measured on the H100)
    corr = torch.zeros(Nold, dtype=w.dtype, device=dev).index_put_(
        (idx[valid],), w[valid], accumulate=True)
    corr = torch.where(corr > 0, corr, torch.ones_like(corr))
    w = w * in_vareas[cidx] / corr[cidx]
    rowsum = w.sum(1, keepdim=True)
    pos_row = rowsum > 0
    w = torch.where(pos_row, w / torch.where(pos_row, rowsum,
                                             torch.ones_like(rowsum)),
                    torch.zeros_like(w))
    return idx, w


def interpolate_with_exclusion(idx, w, data, excl=None):
    """barycentric_data_interpolation core (resampler.cpp:40-67).
    Returns (out (D,Q), new_excl (Q,) | None)."""
    if excl is None:
        return apply_weights(idx, w, data), None
    inc = (excl != 0).to(w.dtype)
    w_data = w * inc[idx.clamp(0, excl.shape[0] - 1)]
    return (apply_weights(idx, w_data, data),
            apply_weights(idx, w_data, excl[None, :])[0])


def smooth_kernel(coords, data, sigma: float, excl=None, chunk: int = 2048):
    """Geodesic Gaussian smoothing (smooth_data, resampler.cpp:169-230),
    reproducing the reference's unit-sphere distance scale (see the JAX
    original). Data and output live on the same mesh.
    Returns (smoothed (D,N), new_excl (N,))."""
    unit = coords / torch.linalg.norm(coords, dim=1, keepdim=True)
    ang = 4.0 * math.asin(sigma / (2.0 * RAD))
    cos_ang = math.cos(ang)
    norm_const = 1.0 / math.sqrt(2.0 * math.pi * sigma * sigma)

    outs, new_es = [], []
    for s in range(0, unit.shape[0], chunk):
        dots = unit[s:s + chunk] @ unit.T                         # (c,N)
        mask = dots >= cos_ang
        chord = torch.sqrt(torch.clamp(2.0 - 2.0 * dots, min=0.0))
        g = 2.0 * RAD * torch.arcsin((chord / (2.0 * RAD)).clamp(-1.0, 1.0))
        wfull = norm_const * torch.exp(-(g * g) / (2.0 * sigma * sigma)) * mask
        excl_sum = wfull.sum(1)
        w = wfull if excl is None else wfull * excl[None, :]
        ws = w.sum(1)
        outs.append((w @ data.T).T / torch.where(ws != 0, ws,
                                                  torch.ones_like(ws)))
        new_es.append(torch.where(
            excl_sum != 0,
            ws / torch.where(excl_sum != 0, excl_sum, torch.ones_like(ws)),
            torch.zeros_like(ws)))
    out = torch.cat(outs, dim=1)
    new_e = torch.cat(new_es)
    if excl is not None:
        # rows whose own vertex is excluded output zero (resampler.cpp:201,222)
        incl = excl != 0
        out = torch.where(incl[None, :], out, torch.zeros_like(out))
        new_e = torch.where(incl, new_e, torch.zeros_like(new_e))
    return out, new_e


def warp_coords(coords, frm_tables: SearchTables, to_coords):
    """Core of sphere_project_warp: (Q,3) -> (Q,3) at radius 100."""
    idx, w = barycentric_coords(coords, frm_tables)
    newp = apply_weights(idx, w, to_coords.T).T
    return sph.normalize(newp) * RAD


# --------------------------------------------------------------------------
# mesh-level wrappers (numpy meshes in and out, explicit device)
# --------------------------------------------------------------------------

def _tables(mesh: Mesh, device) -> SearchTables:
    return build_tables(mesh.coords, mesh.faces, mesh.adjacency[2], device)


def _adaptive_cap(nold: int, nnew: int) -> int:
    return max(16, 4 * (3 * nold // max(nnew, 1) + 1))


def metric_resample(data_mesh: Mesh, low_mesh: Mesh,
                    excl: np.ndarray | None = None, device="cpu"):
    """Adaptive-barycentric metric resampling (metric_resample,
    resampler.cpp:304-309). Returns (Mesh on low topology with resampled
    data, resampled exclusion mask | None)."""
    excl_t = None if excl is None else _f32(excl, device)
    idx, w = adaptive_weights(
        _f32(data_mesh.coords, device), _f32(low_mesh.coords, device),
        _tables(data_mesh, device), _tables(low_mesh, device),
        _f32(data_mesh.vertex_area(), device),
        _f32(low_mesh.vertex_area(), device), excl_t,
        cap=_adaptive_cap(data_mesh.nvertices, low_mesh.nvertices))
    out, new_excl = interpolate_with_exclusion(
        idx, w, _f32(data_mesh.data, device), excl_t)
    result = Mesh(coords=low_mesh.coords.copy(), faces=low_mesh.faces,
                  data=out.cpu().numpy().astype(np.float64))
    return result, (None if new_excl is None
                    else new_excl.cpu().numpy().astype(np.float64))


def smooth_data(mesh: Mesh, sigma: float, excl: np.ndarray | None = None,
                device="cpu"):
    """Smooth mesh data (reference featurespace use, orig == sphLow).
    Returns (new Mesh, new_excl | None)."""
    out, new_e = smooth_kernel(
        _f32(mesh.coords, device), _f32(mesh.data, device), float(sigma),
        None if excl is None else _f32(excl, device))
    result = Mesh(coords=mesh.coords.copy(), faces=mesh.faces,
                  data=out.cpu().numpy().astype(np.float64))
    return result, (None if excl is None
                    else new_e.cpu().numpy().astype(np.float64))


def nearest_neighbour_interpolation(data_mesh: Mesh, low_mesh: Mesh,
                                    excl: np.ndarray | None = None,
                                    device="cpu"):
    """(resampler.cpp:232-258)."""
    nn = closest_vertex(_f32(low_mesh.coords, device),
                        _tables(data_mesh, device)).cpu().numpy()
    data = data_mesh.data[:, nn]
    new_excl = None
    if excl is not None:
        gate = excl[nn] != 0
        data = data * gate[None, :]
        new_excl = np.where(gate, excl[nn], 0.0)
    result = Mesh(coords=low_mesh.coords.copy(), faces=low_mesh.faces, data=data)
    return result, new_excl


def sphere_project_warp(sphere: Mesh, frm: Mesh, to: Mesh, device="cpu") -> Mesh:
    """Express sphere vertices barycentrically in `frm`, re-evaluate in `to`,
    re-project to radius 100 (resampler.cpp:311-328). Returns a new Mesh."""
    new_coords = warp_coords(_f32(sphere.coords, device), _tables(frm, device),
                             _f32(to.coords, device))
    return Mesh(coords=new_coords.cpu().numpy().astype(np.float64),
                faces=sphere.faces,
                data=None if sphere.data is None else sphere.data.copy())
