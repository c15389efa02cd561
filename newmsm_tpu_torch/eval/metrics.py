"""Registration quality metrics.

Self-contained replacements for the external evaluation tooling the
reference pipelines shell out to (`wb_command -surface-distortion`, the
gMSM_tutorial/compare_stats.py statistics): areal and shape distortion maps
on the log2 scale, pairwise cross-correlation, and DICE overlap of
top-percentile masks (compare_stats.py:20-60, get_group_stats.py:36-80). The port's own copy of
the JAX package's eval/metrics.py: host numpy in float64, the face frames
through core.spherical on CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import spherical as sph
from ..core.mesh import Mesh


def _face_stretches(orig: Mesh, reg: Mesh):
    """Per-face singular values (smax, smin) of the 2-D deformation gradient
    from the original to the registered surface."""
    def edges2d(mesh):
        v = np.asarray(mesh.coords, np.float64)[mesh.faces]   # (T,3,3)
        vt = torch.from_numpy(v)
        n = sph.tri_normal(vt[:, 0], vt[:, 1], vt[:, 2])
        e1, e2 = (e.numpy() for e in sph.tangent_basis_from_normal(n))
        x = np.einsum("tvk,tk->tv", v, e1)
        y = np.einsum("tvk,tk->tv", v, e2)
        return np.stack([x, y], axis=-1)                   # (T,3,2)

    a = edges2d(orig)
    b = edges2d(reg)
    ea = np.stack([a[:, 1] - a[:, 0], a[:, 2] - a[:, 0]], axis=-1)  # (T,2,2)
    eb = np.stack([b[:, 1] - b[:, 0], b[:, 2] - b[:, 0]], axis=-1)
    f = eb @ np.linalg.inv(ea)
    s = np.linalg.svd(f, compute_uv=False)                 # (T,2) descending
    return s[:, 0], s[:, 1]


def distortion_maps(orig: Mesh, reg: Mesh):
    """Per-vertex areal and shape distortion on the log2 scale (the
    `wb_command -surface-distortion -local-affine-method -log2` contract used
    by run_gMSM.sh:118): areal = log2(smax*smin), shape = log2(smax/smin),
    averaged over incident faces. Returns (areal (N,), shape (N,))."""
    smax, smin = _face_stretches(orig, reg)
    smin = np.maximum(smin, 1e-12)
    areal_f = np.log2(np.maximum(smax * smin, 1e-12))
    shape_f = np.log2(smax / smin)
    _, _, tri_idx, tri_cnt = orig.adjacency
    gathered_a = areal_f[np.where(tri_idx >= 0, tri_idx, 0)] * (tri_idx >= 0)
    gathered_s = shape_f[np.where(tri_idx >= 0, tri_idx, 0)] * (tri_idx >= 0)
    denom = np.maximum(tri_cnt, 1)
    return gathered_a.sum(1) / denom, gathered_s.sum(1) / denom


def distortion_stats(areal: np.ndarray, shape: np.ndarray) -> dict:
    """Summary rows of the reference's published distortion table
    (abs-value statistics)."""
    a = np.abs(areal)
    s = np.abs(shape)
    return {
        "areal_mean": float(a.mean()),
        "areal_max": float(a.max()),
        "areal_95": float(np.percentile(a, 95)),
        "areal_98": float(np.percentile(a, 98)),
        "shape_mean": float(s.mean()),
        "shape_max": float(s.max()),
    }


def cross_correlation(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


def mean_pairwise_cc(maps: list[np.ndarray]) -> float:
    """Average CC over all subject pairs (compare_stats.py:20-28)."""
    cs = [cross_correlation(maps[i], maps[j])
          for i in range(len(maps)) for j in range(i + 1, len(maps))]
    return float(np.mean(cs))


def dice_overlap(a: np.ndarray, b: np.ndarray, percentile: float = 75.0) -> float:
    """DICE of top-percentile masks (compare_stats.py:30-45)."""
    ta = np.percentile(a, percentile)
    tb = np.percentile(b, percentile)
    ma = a >= ta
    mb = b >= tb
    denom = ma.sum() + mb.sum()
    return float(2.0 * (ma & mb).sum() / denom) if denom else 0.0


def mean_pairwise_dice(maps: list[np.ndarray], percentile: float = 75.0) -> float:
    ds = [dice_overlap(maps[i].ravel(), maps[j].ravel(), percentile)
          for i in range(len(maps)) for j in range(i + 1, len(maps))]
    return float(np.mean(ds))
