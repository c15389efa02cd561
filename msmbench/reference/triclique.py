"""Plain reference of the triclique likelihood, the data term of newMSM's
`--triclique` (HO triplet_likelihood, DiscreteCostFunction.cpp:487-531
univariate, :565-618 multivariate), in plain PyTorch at the precision the
caller picks (float64 for the reference; float32 with TF32-rounded inputs
for the control), with TF32 products off.

For one CP triangle (a triplet) and one combination of its corners'
labels, every source vertex of the triangle's patch is

  1. scaled along its ray onto the plane of the CURRENT CP triangle
     (project_point, point.cpp:46-60);
  2. given barycentric weights there from the areas of the three
     sub-triangles (triangle.cpp:159-172, unsigned areas);
  3. re-placed with those weights at the corners' label positions (the
     deformed triangle) and put back on the sphere;
  4. located on the target icosphere by brute force: the faces with the
     nearest centroids first, every face for a point none of them holds
     (geometry.locate), in blocks; the target data is interpolated there
     with the barycentric weights of the point's central projection;

and the source patch is compared with the target values it found:
univariate, the weighted similarity of channel 0 over the patch;
multivariate, per vertex the weighted similarity of its channel vector,
averaged over the patch. The cost is that similarity times the mean of
the corners' absolute weights.

Departures from DiscreteCostFunction.cpp, each deliberate:

- the face patches (which source vertices belong to which CP triangle,
  get_source_data :468-485, an octree there) are taken as given by
  `likelihood`, which checks the likelihood of the patches the program
  built, and only their masked-in slots; `patch_faults` checks the patch
  build on its own: every source vertex in exactly one masked-in slot, of
  a CP triangle that holds it;
- the target is searched by brute force instead of the octree / mesh
  neighbourhood walk, and interpolated with central-projection weights
  (Cramer's rule); for a point inside its face both give the same
  weights;
- similarity 1 (SSD) and 2 (Pearson) only; the DICE measures (4, 5) are
  not implemented and raise;
- an empty patch, or a zero variance, gives a correlation of 0, as the
  program's similarity does (similarities.cpp:129-158).

Imports torch and the reference's geometry only: nothing of the program
under test.
"""
from __future__ import annotations

import numpy as np
import torch

from . import geometry as G

SIM_SSD = 1
SIM_CORR = 2
FLOAT64 = G.FLOAT64
CONTROL = G.Precision(torch.float32, tf32_inputs=True)


# a masked-in source vertex lies in its CP triangle when the least
# barycentric weight of its central projection is at least -PATCH_TOL.
# newMSM's octree, and the program after it (core/spherical.py
# point_in_triangle_relative, rel_tol 1e-4), count a point as inside a
# face down to a weight of -1e-4 and give a point near an edge to either
# face: a deformed CP grid reads down to -1.0e-4, the pristine ico-4 grid
# of the cell -2.8e-5; twice that tolerance leaves room for the float32
# rounding of the program's test. A vertex put in a neighbouring triangle
# reads a weight of the order of its distance to the edge over the
# triangle's height, -0.1 for most vertices, down to -1
PATCH_TOL = 2e-4


def _ids(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=device).to(torch.int64)


def patch_faults(cp, triplets, face_idx, face_mask, src,
                 prec: G.Precision = FLOAT64, device="cpu") -> dict:
    """The faults of the face patches the program built for one likelihood
    call: source vertices not in exactly one masked-in slot (dropped at a
    full patch, or kept twice), and masked-in slots whose vertex lies
    outside their CP triangle (beyond PATCH_TOL, or on the far side of the
    sphere). Arguments as `likelihood` takes them. Returns {"unplaced",
    "outside", "least_weight"}."""
    cp, src = prec(cp, device), prec(src, device)
    t, face_idx = _ids(triplets, device), _ids(face_idx, device)
    mask = _ids(face_mask, device) > 0
    ti, pi = torch.nonzero(mask, as_tuple=True)
    vid = face_idx[ti, pi]
    slots = torch.bincount(vid, minlength=src.shape[0])
    tri = cp[t[ti]]                                       # (V,3,3)
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    p = src[vid]
    raw = torch.stack([G._det(p, b, c), G._det(a, p, c), G._det(a, b, p)],
                      1) * torch.sign(G._det(a, b, c))[:, None]
    total = raw.sum(1)
    w = raw / torch.where(total > 0, total, torch.ones_like(total))[:, None]
    least = w.min(1).values
    outside = (total <= 0) | (least < -PATCH_TOL)
    return {"unplaced": int((slots != 1).sum()),
            "outside": int(outside.sum()),
            "least_weight": float(least.min()) if least.numel() else 0.0}


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _area(a, b, c):
    return 0.5 * torch.linalg.norm(_cross(b - a, c - a), dim=-1)


def weighted_corr(a, b, w):
    """Weighted Pearson correlation over the last axis (weights w, zero for
    slots that do not count); 0 where the weights sum to 0 or a variance
    is 0."""
    s = w.sum(-1)
    pos = s > 0
    safe = torch.where(pos, s, torch.ones_like(s))
    ma = (w * a).sum(-1) / safe
    mb = (w * b).sum(-1) / safe
    da = a - ma[..., None]
    db = b - mb[..., None]
    cov = (w * da * db).sum(-1) / safe
    va = (w * da * da).sum(-1) / safe
    vb = (w * db * db).sum(-1) / safe
    ok = pos & (va > 0) & (vb > 0)
    den = torch.sqrt(torch.where(ok, va * vb, torch.ones_like(va)))
    return torch.where(ok, cov / den, torch.zeros_like(cov))


def similarity(a, b, w, count, simval: int):
    """The cost of comparing a with b over the last axis: SSD
    sqrt(sum w (a-b)^2) / count, or Pearson 1 - (1 + r) / 2."""
    if simval == SIM_SSD:
        return torch.sqrt((w * (a - b) ** 2).sum(-1)) / count.clamp(min=1)
    if simval == SIM_CORR:
        return 1.0 - (1.0 + weighted_corr(a, b, w)) / 2.0
    raise ValueError(f"the reference has no similarity {simval}")


def likelihood(cp, rl, triplets, face_idx, face_mask, src, abs_weights,
               cfweights, source_data, target_coords, target_faces,
               target_data, la, lb, lc, simval: int, multivariate: bool,
               prec: G.Precision = FLOAT64, device="cpu",
               block: int = 2048) -> dict:
    """The (T,C) triclique likelihood.

    cp (K,3) current CP grid; rl (K,L,3) label positions a CP; triplets
    (T,3) CP ids; face_idx / face_mask (T,P) the patches' source vertex ids
    and masked-in slots; src (N,3) source vertices; abs_weights (K,);
    cfweights (Dw,N), Dw 1 or D; source_data (D,N); the target icosphere's
    coords (Nt,3), faces (Ft,3) and data (D,Nt); la, lb, lc (T,C) the
    corners' label ids; numpy arrays or CPU tensors, moved to `device`.
    Returns {"lik": (T,C), "outside": points no target face holds}."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _likelihood(
            prec(cp, device), prec(rl, device), _ids(triplets, device),
            _ids(face_idx, device), _ids(face_mask, device) > 0,
            prec(src, device), prec(abs_weights, device),
            prec(cfweights, device), prec(source_data, device),
            prec(target_coords, device), _ids(target_faces, device),
            prec(target_data, device), _ids(la, device), _ids(lb, device),
            _ids(lc, device), simval, multivariate, block)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _likelihood(cp, rl, t, face_idx, mask, src, absw, cfw, sdata, tcoords,
                tfaces, tdata, la, lb, lc, simval, multivariate, block):
    T, P = face_idx.shape
    C = la.shape[1]
    D = sdata.shape[0]
    ti, pi = torch.nonzero(mask, as_tuple=True)          # masked-in slots
    p = src[face_idx[ti, pi]]                             # (V,3)
    c0, c1, c2 = (cp[t[ti, k]] for k in range(3))
    normal = _cross(c1 - c0, c2 - c0)
    on_plane = p * ((normal * c0).sum(-1) / (normal * p).sum(-1))[:, None]
    wa = _area(on_plane, c1, c2)
    wb = _area(on_plane, c0, c2)
    wc = _area(on_plane, c0, c1)
    tot = wa + wb + wc
    moved = (wa[:, None, None] * rl[t[ti, 0][:, None], la[ti]]
             + wb[:, None, None] * rl[t[ti, 1][:, None], lb[ti]]
             + wc[:, None, None] * rl[t[ti, 2][:, None], lc[ti]]) \
        / tot[:, None, None]                              # (V,C,3)
    moved = moved / torch.linalg.norm(moved, dim=-1, keepdim=True) * G.RAD
    fid, w, outside = G.locate(moved.reshape(-1, 3), tcoords, tfaces,
                               block=block)
    vals = (w[..., None] * tdata.T[tfaces[fid]]).sum(1)  # (V*C,D)

    tgt = torch.zeros((T, C, P, D), dtype=vals.dtype, device=vals.device)
    tgt[ti, :, pi] = vals.reshape(-1, C, D)
    m = mask.to(vals.dtype)                               # (T,P)
    a = sdata[:, face_idx].permute(1, 2, 0)               # (T,P,D)
    wts = cfw[:, face_idx].permute(1, 2, 0)               # (T,P,Dw)
    if not multivariate:
        w0 = (wts[..., 0] * m)[:, None, :].expand(T, C, P)
        sim = similarity(a[..., 0][:, None, :].expand(T, C, P),
                         tgt[..., 0], w0,
                         m.sum(-1)[:, None].expand(T, C), simval)
    else:
        wd = wts if wts.shape[-1] == D else wts[..., :1].expand(T, P, D)
        per_vertex = similarity(
            a[:, None].expand(T, C, P, D), tgt,
            wd[:, None].expand(T, C, P, D),
            torch.full((T, C, P), float(D), dtype=vals.dtype,
                       device=vals.device), simval)       # (T,C,P)
        sim = (per_vertex * m[:, None]).sum(-1) \
            / m.sum(-1).clamp(min=1)[:, None]
    corner = (absw[t[:, 0]] + absw[t[:, 1]] + absw[t[:, 2]]) / 3.0
    return {"lik": corner[:, None] * sim, "outside": outside}
