"""Plain reference geometry for judging registration outputs.

Straightforward implementations, in plain PyTorch at a precision the
caller picks (float64 for the reference; float32 with TF32-rounded inputs
for the control), of the operations whose results the benchmark compares:

  * locating points on a triangulated sphere (the containing triangle by
    orientation tests, candidates from the nearest face centroids),
  * barycentric weights of a point's central projection on its triangle,
  * adaptive barycentric (area-corrected) metric resampling, as Workbench's
    ADAP_BARY_AREA defines it,
  * projecting a sphere through a warp (express in one mesh, evaluate in
    another),
  * log2 areal and shape distortion of a warp, folded triangles, and
    Pearson correlation.

Imports torch and numpy only: nothing of the program under test.
"""
from __future__ import annotations

import numpy as np
import torch

RAD = 100.0


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """`t` as float32 with its mantissa rounded to TF32's 10 bits (round to
    nearest, ties away from zero), the rounding a TF32 tensor-core product
    applies to its operands."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Precision:
    """How the reference computes: `dtype`, and whether every float input
    is first rounded to TF32."""

    def __init__(self, dtype=torch.float64, tf32_inputs: bool = False):
        self.dtype = dtype
        self.tf32_inputs = tf32_inputs

    def __call__(self, a, device) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a), device=device)
        if self.tf32_inputs:
            t = tf32_round(t)
        return t.to(self.dtype)


FLOAT64 = Precision(torch.float64)


def _det(a, b, c):
    """Row-wise det[a; b; c] = a . (b x c)."""
    return (a * torch.linalg.cross(b, c, dim=-1)).sum(-1)


def face_orientation(coords, faces):
    """Sign of det[v0; v1; v2] of each face (+1 / -1 / 0)."""
    v = coords[faces]
    return torch.sign(_det(v[:, 0], v[:, 1], v[:, 2]))


def locate(points, coords, faces, k: int = 32, block: int = 2048):
    """Containing triangle of each point on the closed sphere mesh
    (coords (N,3), faces (T,3) int64; any radius). A point is in a face
    when the three orientation tests det[p; vi; vj] all share the face's own
    orientation; the candidates are the `k` faces with the nearest
    centroids, and a point none of them holds is tested against every face.
    Returns (face ids (Q,), barycentric weights (Q,3) of the point's central
    projection onto the face's plane, number of points in no face)."""
    dev, dt = coords.device, coords.dtype
    v = coords[faces]                                        # (T,3,3)
    vol = _det(v[:, 0], v[:, 1], v[:, 2])
    orient = torch.sign(vol)
    size = torch.abs(vol).clamp(min=torch.finfo(dt).tiny)
    cen = v.sum(1)
    cen = cen / torch.linalg.norm(cen, dim=1, keepdim=True)
    unit = points / torch.linalg.norm(points, dim=1, keepdim=True)
    k = min(k, faces.shape[0])
    tol = -64 * torch.finfo(dt).eps       # rounding at edges and corners

    def inside_score(p, f):
        """The least of the three orientation tests, signed by the face's
        orientation and over the face's own determinant (>= 0 inside)."""
        a, b, c = v[f, 0], v[f, 1], v[f, 2]
        s = orient[f] / size[f]
        d0 = _det(p, b, c) * s
        d1 = _det(a, p, c) * s
        d2 = _det(a, b, p) * s
        return torch.minimum(d0, torch.minimum(d1, d2))

    fid = torch.empty(points.shape[0], dtype=torch.int64, device=dev)
    for s in range(0, points.shape[0], block):
        p = unit[s:s + block]
        cand = torch.topk(p @ cen.T, k, dim=1).indices       # (B,k)
        score = inside_score(p[:, None, :].expand(-1, k, -1), cand)
        best = score.argmax(1)
        fid[s:s + block] = cand[torch.arange(p.shape[0], device=dev), best]
    # points no candidate holds: every face (rare; folds or thin faces)
    missed = torch.nonzero(inside_score(unit, fid) < tol).flatten()
    for s in range(0, missed.numel(), 64):
        rows = missed[s:s + 64]
        p = unit[rows]
        allf = torch.arange(faces.shape[0], device=dev)
        score = inside_score(p[:, None, :].expand(-1, faces.shape[0], -1),
                             allf[None, :].expand(p.shape[0], -1))
        fid[rows] = score.argmax(1)
    outside = int((inside_score(unit, fid) < tol).sum())
    return fid, bary_weights(unit, v[fid]), outside


def bary_weights(p, tri):
    """Weights w (Q,3) with sum 1 and w0 a + w1 b + w2 c on the ray of p:
    the barycentric coordinates of p's central projection onto the plane of
    the triangle tri (Q,3,3), by Cramer's rule."""
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    w = torch.stack([_det(p, b, c), _det(a, p, c), _det(a, b, p)], 1)
    return w / w.sum(1, keepdim=True)


def vertex_areas(coords, faces):
    """Mean area of the (flat) triangles incident to each vertex."""
    v = coords[faces]
    area = 0.5 * torch.linalg.norm(
        torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], dim=-1),
        dim=-1)
    n = coords.shape[0]
    total = torch.zeros(n, dtype=coords.dtype, device=coords.device)
    count = torch.zeros_like(total)
    for j in range(3):
        total.index_add_(0, faces[:, j], area)
        count.index_add_(0, faces[:, j], torch.ones_like(area))
    return total / count.clamp(min=1)


def adaptive_resample(src_coords, src_faces, data, dst_coords, dst_faces,
                      cap: int | None = None):
    """Resample `data` (D, N_src) from the source sphere onto the vertices
    of the destination sphere by adaptive barycentric area weighting:

    each destination vertex t takes the barycentric row of its location in
    the source mesh, unless more than 3 source vertices locate into
    destination faces that have t as a corner; then it takes those source
    vertices with their (reverse) barycentric weights for t (the first
    `cap` of them by source index). Each weight is scaled by t's vertex
    area, then by the source vertex's area over the sum of its scaled
    weights over all rows, and each row is normalised to sum 1.
    Returns (out (D, N_dst), points outside every face)."""
    dev, dt = src_coords.device, src_coords.dtype
    n_src, n_dst = src_coords.shape[0], dst_coords.shape[0]
    if cap is None:
        cap = max(16, 4 * (3 * n_src // max(n_dst, 1) + 1))
    f_fid, f_w, out_f = locate(dst_coords, src_coords, src_faces)
    f_idx = src_faces[f_fid]                                 # (Nd,3)
    r_fid, r_w, out_r = locate(src_coords, dst_coords, dst_faces)
    r_idx = dst_faces[r_fid]                                 # (Ns,3) dst ids

    # reverse entries grouped by destination vertex, source ids ascending
    tgt = r_idx.reshape(-1)
    src = torch.arange(n_src, device=dev).repeat_interleave(3)
    wgt = r_w.reshape(-1)
    order = torch.argsort(tgt * n_src + src)
    tgt, src, wgt = tgt[order], src[order], wgt[order]
    counts = torch.bincount(tgt, minlength=n_dst)
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(tgt.numel(), device=dev) - start[tgt]
    keep = pos < cap
    use_rev = counts > 3

    # rows as (dst, src, weight) triples
    rev_rows = keep & use_rev[tgt]
    fwd_dst = torch.arange(n_dst, device=dev).repeat_interleave(3)
    fwd_rows = ~use_rev[fwd_dst]
    row_dst = torch.cat([tgt[rev_rows], fwd_dst[fwd_rows]])
    row_src = torch.cat([src[rev_rows], f_idx.reshape(-1)[fwd_rows]])
    row_w = torch.cat([wgt[rev_rows], f_w.reshape(-1)[fwd_rows]])

    src_area = vertex_areas(src_coords, src_faces)
    dst_area = vertex_areas(dst_coords, dst_faces)
    row_w = row_w * dst_area[row_dst]
    corr = torch.zeros(n_src, dtype=dt, device=dev).index_add_(0, row_src,
                                                               row_w)
    corr = torch.where(corr > 0, corr, torch.ones_like(corr))
    row_w = row_w * src_area[row_src] / corr[row_src]
    rowsum = torch.zeros(n_dst, dtype=dt, device=dev).index_add_(0, row_dst,
                                                                 row_w)
    row_w = row_w / torch.where(rowsum > 0, rowsum,
                                torch.ones_like(rowsum))[row_dst]
    out = torch.zeros((data.shape[0], n_dst), dtype=dt, device=dev)
    out.index_add_(1, row_dst, data[:, row_src] * row_w[None, :])
    return out, out_f + out_r


def project_warp(points, frm_coords, frm_faces, to_coords):
    """Each point expressed barycentrically in the `frm` mesh and evaluated
    with the same weights on the `to` coordinates (same topology), then put
    back on the sphere of radius RAD. Returns (coords, points outside)."""
    fid, w, outside = locate(points, frm_coords, frm_faces)
    tri = to_coords[frm_faces[fid]]                          # (Q,3,3)
    new = (w[..., None] * tri).sum(1)
    return new / torch.linalg.norm(new, dim=1, keepdim=True) * RAD, outside


def folded_faces(coords, faces, reference_orientation):
    """Faces whose orientation differs from the reference mesh's."""
    return int((face_orientation(coords, faces)
                != reference_orientation).sum())


def distortion(orig_coords, reg_coords, faces):
    """Per-vertex log2 areal and shape distortion of the map orig -> reg,
    averaged over each vertex's faces: per face the affine map between the
    two flat triangles has singular values s1 >= s2, areal = log2(s1 s2)
    (the area ratio), shape = log2(s1 / s2). Returns (areal, shape)."""
    def frame(c):
        v = c[faces]
        e1 = v[:, 1] - v[:, 0]
        e2 = v[:, 2] - v[:, 0]
        n = torch.linalg.cross(e1, e2, dim=-1)
        x = e1 / torch.linalg.norm(e1, dim=1, keepdim=True)
        y = torch.linalg.cross(n, x, dim=-1)
        y = y / torch.linalg.norm(y, dim=1, keepdim=True)
        # the two edges in the triangle's own orthonormal frame (2x2)
        return torch.stack([torch.stack([(e1 * x).sum(1), (e2 * x).sum(1)], 1),
                            torch.stack([(e1 * y).sum(1), (e2 * y).sum(1)], 1)],
                           1)
    a = frame(orig_coords)
    b = frame(reg_coords)
    f = b @ torch.linalg.inv(a)
    # singular values of each 2x2 map, in the stable closed form
    p, q = f[:, 0, 0], f[:, 0, 1]
    r, t = f[:, 1, 0], f[:, 1, 1]
    e, g = (p + t) / 2, (p - t) / 2
    h, k = (r + q) / 2, (r - q) / 2
    s1 = torch.sqrt(e * e + k * k) + torch.sqrt(g * g + h * h)
    s2 = torch.clamp(torch.abs(p * t - q * r) / s1, min=1e-12)
    areal_f = torch.log2(torch.clamp(s1 * s2, min=1e-12))
    shape_f = torch.log2(s1 / s2)
    n = orig_coords.shape[0]
    tot_a = torch.zeros(n, dtype=f.dtype, device=f.device)
    tot_s = torch.zeros_like(tot_a)
    cnt = torch.zeros_like(tot_a)
    for j in range(3):
        tot_a.index_add_(0, faces[:, j], areal_f)
        tot_s.index_add_(0, faces[:, j], shape_f)
        cnt.index_add_(0, faces[:, j], torch.ones_like(areal_f))
    cnt = cnt.clamp(min=1)
    return tot_a / cnt, tot_s / cnt


def distortion_stats(areal, shape) -> dict:
    """The summary rows of the published distortion table (statistics of
    absolute values)."""
    a = torch.abs(areal)
    s = torch.abs(shape)
    return {"areal_mean": float(a.mean()), "areal_max": float(a.max()),
            "areal_95": float(torch.quantile(a, 0.95)),
            "areal_98": float(torch.quantile(a, 0.98)),
            "shape_mean": float(s.mean()), "shape_max": float(s.max())}


def pearson(a, b) -> float:
    a = a.reshape(-1) - a.mean()
    b = b.reshape(-1) - b.mean()
    return float((a * b).sum() / torch.sqrt((a * a).sum() * (b * b).sum()))


def angle_deg(a, b):
    """Angle in degrees between matching rows of a and b."""
    an = a / torch.linalg.norm(a, dim=1, keepdim=True)
    bn = b / torch.linalg.norm(b, dim=1, keepdim=True)
    return torch.rad2deg(torch.atan2(
        torch.linalg.norm(torch.linalg.cross(an, bn, dim=-1), dim=1),
        (an * bn).sum(1)))
