"""MRF cost volumes for discrete surface registration.

Port of newmsm_tpu/reg/costs.py; each term is one batched computation
producing the tensor the optimisers consume:

  unary    (K, L)      patch rotate -> pristine locate (the CUDA kernel) ->
                       barycentric target gather -> similarity
  triplet  (T, ...)    folding gate + closed-form strain (spherical, or on
                       the anatomy for regoption 5), + triclique likelihood
  pairwise (Pr, L, L)  label-rotation difference + folding gate

Every lookup on a pristine icosphere (unary, triclique, the anatomical
sphere of regoption 5) goes through ops/locate.py::locate_bary. The exact
target gather is used throughout (the JAX package's blocked
gather, ops/blocked.py, exists for the TPU's gather rate and is not
ported). The patch helpers (`_ball_table_np`, `patch_candidate_ball`) are
host numpy; their dense float64 searches (`_ball_cover`,
`max_inrange_count`) run on the device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import FIX_NAN, FOLDING, RAD, resolve_device, trace
from ..core import spherical as sph
from ..core.icosphere import _NVERT_TO_RES, icosphere
from ..ops import similarity as simi
from ..ops.nearest import (SearchTables, _bfs_ball, _search,
                           barycentric_coords, nearest_triangle,
                           resample_pristine_soa)
from ..ops.strain import triangular_strain

# graph-ball depths tried, in order, by `patch_candidate_ball`
BALL_DEPTHS = (4, 6, 8, 10, 12, 14, 16)

# slack on the in-range limit when counting patch members for the overflow
# (grow-pmax) signal: absorbs the matmul-form score noise
_OVERFLOW_GUARD = 1e-2


class LevelTables(NamedTuple):
    """Static per-level device state."""
    target_tables: SearchTables     # data-grid target mesh (fixed per level)
    target_data: torch.Tensor       # (D,N)
    source_data: torch.Tensor       # (D,N)
    orig_cp: torch.Tensor           # (K,3) level-start CP grid
    triplets: torch.Tensor          # (T,3) sorted CP vertex ids
    pairs: torch.Tensor             # (Pr,2) CP edges
    cp_faces: torch.Tensor          # (T,3) CP faces in native order
    cp_tri_idx: torch.Tensor        # (K,MT) incident CP faces, -1 padded
    maxsep: torch.Tensor            # (K,) per-CP max spacing (level init)
    mvd_max: torch.Tensor           # scalar


def _arc(chord):
    return 2.0 * RAD * torch.arcsin((chord / (2.0 * RAD)).clamp(-1.0, 1.0))


# --------------------------------------------------------------------------
# patches
# --------------------------------------------------------------------------

def build_patches(cp_coords, src_coords, maxsep, cprange, pmax: int,
                  ball=None):
    """In-range source vertices per control point (within_controlpt_range,
    DiscreteCostFunction.cpp:102-107): geodesic distance < cprange*maxsep_k.
    Returns (idx (K,pmax) int64, mask (K,pmax), overflow (K,) bool).

    `ball`: optional (K,C) candidate table (-1 padded) from
    `patch_candidate_ball`, restricting the search per CP with exact
    in-range semantics. Patch members are ordered nearest first; on exact
    distance ties torch.topk may order them differently from lax.top_k, so
    compare patches as sets."""
    limit = (cprange * maxsep)[:, None]
    if ball is not None:
        C = ball.shape[1]
        cand = torch.nn.functional.pad(ball, (0, max(pmax - C, 0)), value=-1)
        valid = cand >= 0
        diff = src_coords[cand.clamp(min=0)] - cp_coords[:, None, :]
        dist = _arc(torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0)))
        dist = torch.where(valid, dist, torch.full_like(dist, float("inf")))
        sel = torch.topk(-dist, pmax, dim=1).indices           # nearest first
        idx = torch.gather(cand, 1, sel)
        mask = torch.gather(dist, 1, sel) < limit
        overflow = (dist < limit + _OVERFLOW_GUARD).sum(1) > pmax
        return idx.clamp(min=0), mask, overflow
    # dense path: matmul-form scores rank candidates (fast but noisy, full
    # float32 since TF32 is off); the in-range mask is decided on EXACT
    # small-difference distances
    chord2 = ((cp_coords ** 2).sum(1)[:, None]
              - 2.0 * (cp_coords @ src_coords.T)
              + (src_coords ** 2).sum(1)[None, :])
    dist_n = _arc(torch.sqrt(torch.clamp(chord2, min=0.0)))
    idx = torch.topk(-dist_n, pmax, dim=1).indices
    diff = src_coords[idx] - cp_coords[:, None, :]
    d_sel = _arc(torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0)))
    overflow = (dist_n < limit + _OVERFLOW_GUARD).sum(1) > pmax
    return idx, d_sel < limit, overflow


@trace.cached()
def _ball_table_np(res: int, n_centres: int, depth: int):
    """(n_centres, C) graph-ball candidate table on the pristine level-`res`
    icosphere, -1 padded (CP ids are a prefix of the fine ids)."""
    tab = _bfs_ball(icosphere(res).nbr_idx, n_centres, depth)
    # self-padding duplicates -> -1 (they would double-count in the sims)
    eq = tab == np.arange(n_centres, dtype=tab.dtype)[:, None]
    tab = tab.copy()
    tab[eq & (np.cumsum(eq, axis=1) > 1)] = -1
    return tab


@trace.cached()
def _ball_cover(res: int, n_centres: int, depth: int,
                device: torch.device, chunk: int = 512) -> float:
    """Certified pristine cover radius of `_ball_table_np`: the minimum over
    centres of the arc distance to the nearest non-ball vertex, searched
    over ALL vertices. The arc is monotone in the dot product, so the
    search is a chunked float64 product and masked maximum on `device`,
    with one arccos of the winning dot at the end."""
    tab = torch.from_numpy(_ball_table_np(res, n_centres, depth)).to(
        device, torch.int64)
    u = torch.from_numpy(icosphere(res).coords).to(device)       # f64
    best = torch.full((), -2.0, dtype=u.dtype, device=device)
    for s in range(0, n_centres, chunk):
        t = tab[s:s + chunk]
        dots = u[s:s + t.shape[0]] @ u.T
        # ball members out of the search; -1 padding lands on the centre's
        # own column, a ball member already
        rows = torch.arange(s, s + t.shape[0], device=device)[:, None]
        dots.scatter_(1, torch.where(t >= 0, t, rows), -2.0)
        best = torch.maximum(best, dots.max())
    best = float(best)
    return float("inf") if best < -1.0 else RAD * math.acos(min(best, 1.0))


def patch_candidate_ball(cp_coords, src_coords, faces, limits, rad=RAD,
                         device=None):
    """A candidate ball table for `build_patches` whose exactness
    certificate holds (see the JAX original for the bound), or None (caller
    then uses the dense path). Host numpy except the cover-radius search,
    which runs on `device` (None means cuda)."""
    device = resolve_device(device)
    src_coords = np.asarray(src_coords)
    cp_coords = np.asarray(cp_coords)
    faces = np.asarray(faces)
    N, K = src_coords.shape[0], cp_coords.shape[0]
    res = _NVERT_TO_RES.get(N)
    if res is None or K > N:
        return None
    ico = icosphere(res)
    if ico.faces.shape != faces.shape or not np.array_equal(ico.faces, faces):
        return None
    pri = ico.coords * rad
    ev = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    d_def = np.linalg.norm(src_coords[ev[:, 0]] - src_coords[ev[:, 1]], axis=1)
    d_pri = np.linalg.norm(pri[ev[:, 0]] - pri[ev[:, 1]], axis=1)
    s_max = float((d_def / np.maximum(d_pri, 1e-30)).max())
    if not np.isfinite(s_max) or s_max > 2.0:
        return None
    e_max = float(2.0 * rad * np.arcsin(np.clip(d_def.max() / (2.0 * rad), -1, 1)))
    chord0 = np.linalg.norm(cp_coords - src_coords[:K], axis=1)
    d0 = 2.0 * rad * np.arcsin(np.clip(chord0 / (2.0 * rad), -1, 1))
    r_req = float(s_max * (1.3 * (d0 + np.asarray(limits)).max() + 4.0 * e_max))
    for depth in BALL_DEPTHS:
        if _ball_cover(res, K, depth, device) > r_req:
            tab = _ball_table_np(res, K, depth)
            return None if tab.shape[1] >= N // 2 else tab
    return None


def max_inrange_count(cp_coords, src_coords, limits, rad=RAD,
                      chunk=512, device=None) -> int:
    """Exact max over CPs of the in-range source-vertex count (sizes the
    pmax patch capacity): chunked float64 arcs on `device` (None means
    cuda), one read-back at the end."""
    device = resolve_device(device)

    def unit(a):
        a = torch.as_tensor(np.asarray(a, np.float64)).to(device)
        return a / torch.linalg.norm(a, dim=1, keepdim=True)

    uc, uv = unit(cp_coords), unit(src_coords)
    lim = torch.as_tensor(np.asarray(limits, np.float64)).to(device)
    best = torch.zeros((), dtype=torch.int64, device=device)
    for s in range(0, uc.shape[0], chunk):
        d = rad * torch.arccos((uc[s:s + chunk] @ uv.T).clamp(-1.0, 1.0))
        best = torch.maximum(best, (d < lim[s:s + chunk, None]).sum(1).max())
    return int(best)


def rotated_label_positions(cp_coords, labels, centre):
    """RL[k,l] = R(centre -> CP_k) @ label_l (DiscreteModel.cpp:310-319).
    Returns (rots (K,3,3), rl (K,L,3))."""
    rots = sph.rodrigues(centre.expand(cp_coords.shape), cp_coords)
    return rots, torch.einsum("kij,lj->kli", rots, labels)


# --------------------------------------------------------------------------
# unary data term
# --------------------------------------------------------------------------

def _resample_target(points, tables: SearchTables, target_data):
    """Barycentric-interpolate target data at points (...,3) -> (..., D):
    the locate kernel's path for pristine-icosphere targets, the general
    search for deformed ones."""
    if tables.pristine_res >= 0:
        return resample_pristine_soa(points[..., 0], points[..., 1],
                                     points[..., 2], tables, target_data)
    shape = points.shape[:-1]
    flat = points.reshape(-1, 3)
    tri, _, vc = _search(flat, tables)
    w = sph.barycentric_weights(vc[:, 0], vc[:, 1], vc[:, 2],
                                flat.to(vc.dtype))
    vals = target_data.T[tables.faces[tri]]            # (Q,3,D)
    return torch.einsum("qj,qjd->qd", w, vals).reshape(
        shape + (target_data.shape[0],))


def unary_costs(cp_coords, rl, src_coords, patch_idx, patch_mask,
                tables: SearchTables, src_data, target_data, cfweights,
                abs_weights, simval: int, percentile=0.75,
                mode: str = "univariate", lchunk: int = 4):
    """Unary cost volume (K,L).

    mode 'univariate': weighted sim of scalar patches
    (DiscreteCostFunction.cpp:325-383); 'multivariate': mean over the patch
    of per-vertex feature-vector sims (:385-458); 'patchwise': mean over
    channels of per-channel patch sims (:620-692). rl (K,L,3) rotated label
    positions; cfweights (Dw,N) source weighting (Dw == 1 or D)."""
    if mode not in ("univariate", "multivariate", "patchwise"):
        raise ValueError(mode)
    K, L = rl.shape[0], rl.shape[1]
    D = src_data.shape[0]

    # per-(k,l) patch rotation: current CP position -> label position
    # (computeUnaryCost, DiscreteCostFunction.cpp:378-383)
    rot = sph.rodrigues(cp_coords[:, None, :].expand(rl.shape), rl)
    pts = src_coords[patch_idx]                        # (K,P,3)
    src_patch = src_data[:, patch_idx]                 # (D,K,P)
    w_patch = cfweights[:, patch_idx]                  # (Dw,K,P)
    m = patch_mask.to(src_data.dtype)

    out = []
    for s in range(0, L, lchunk):
        rot_c = rot[:, s:s + lchunk]                   # (K,lc,3,3)
        if tables.pristine_res >= 0:
            # SoA rotate + fused locate/resample, arrays (K,lc,P)
            px, py, pz = (pts[:, None, :, i] for i in range(3))
            r = rot_c[..., None]                       # (K,lc,3,3,1)
            q = [r[:, :, i, 0] * px + r[:, :, i, 1] * py + r[:, :, i, 2] * pz
                 for i in range(3)]
            tgt = resample_pristine_soa(q[0], q[1], q[2], tables, target_data)
        else:
            rpts = torch.einsum("klij,kpj->klpi", rot_c, pts)
            tgt = _resample_target(rpts, tables, target_data)  # (K,lc,P,D)
        if mode == "univariate":
            shp = tgt.shape[:3]
            a = src_patch[0][:, None, :].expand(shp)
            w = w_patch[0][:, None, :].expand(shp)
            mask = m[:, None, :].expand(shp)
            out.append(simi.sim_for_min(a, tgt[..., 0], w, mask, simval,
                                        percentile))
        elif mode == "patchwise":
            b = tgt.permute(0, 1, 3, 2)                # (K,lc,D,P)
            a = src_patch.permute(1, 0, 2)[:, None].expand(b.shape)
            w = w_patch[0][:, None, None, :].expand(b.shape)
            mask = m[:, None, None, :].expand(b.shape)
            out.append(simi.sim_for_min(a, b, w, mask, simval,
                                        percentile).mean(-1))
        else:
            a = src_patch.permute(1, 2, 0)[:, None].expand(tgt.shape)
            wd = w_patch.permute(1, 2, 0)              # (K,P,Dw)
            if wd.shape[-1] != D:
                wd = wd[..., :1].expand(wd.shape[:-1] + (D,))
            w = wd[:, None].expand(tgt.shape)
            per_vtx = simi.sim_for_min(a, tgt, w, torch.ones_like(a), simval,
                                       percentile)     # (K,lc,P)
            mm = m[:, None, :]
            out.append((per_vtx * mm).sum(-1) / torch.clamp(mm.sum(-1), min=1.0))
    return abs_weights[:, None] * torch.cat(out, dim=1)


# --------------------------------------------------------------------------
# triplet regulariser
# --------------------------------------------------------------------------

def triplet_combo_costs(rl, cp_coords, tables: LevelTables, la, lb, lc,
                        reglambda, mu, kappa, k_exp, rexp, fixnan=False):
    """Triplet cost for explicit per-triplet label choices la/lb/lc (T,C)
    (computeTripletCost, DiscreteCostFunction.cpp:135-188, regmode 2/3).
    Returns (T,C)."""
    t = tables.triplets
    va = rl[t[:, 0][:, None], la]
    vb = rl[t[:, 1][:, None], lb]
    vc = rl[t[:, 2][:, None], lc]
    return triplet_costs_from_positions(va, vb, vc, cp_coords, tables,
                                        reglambda, mu, kappa, k_exp, rexp,
                                        fixnan=fixnan)


def _folded(va, vb, vc, cur):
    """Folding gate: deformed corners (T,C,3) against the normals of the
    CURRENT corner coords cur (T,3,3) -> (T,C) bool."""
    n_cur = sph.tri_normal(cur[:, 0], cur[:, 1], cur[:, 2])
    n_def = sph.tri_normal(va, vb, vc)
    return (n_def * n_cur[:, None, :]).sum(-1) < 0.0


def _gated_cost(cost, folded, reglambda, fixnan):
    if fixnan:
        cost = torch.where(torch.isnan(cost), torch.full_like(cost, FIX_NAN),
                           cost)
    return torch.where(folded, torch.full_like(cost, FOLDING * reglambda),
                       cost)


def _strain_costs(va, vb, vc, cur, orig, reglambda, mu, kappa, k_exp, rexp,
                  fixnan=False):
    """lambda * strain^rexp of the deformed corners (T,C,3) against the
    level-start corners orig (T,3,3), FOLDING where the triangle flips
    against the current corners cur (T,3,3)."""
    orig_b = orig[:, None].expand(va.shape[:2] + (3, 3))
    deformed = torch.stack([va, vb, vc], dim=-2)
    strain = triangular_strain(orig_b, deformed, mu, kappa, k_exp)
    return _gated_cost(reglambda * torch.pow(strain, rexp),
                       _folded(va, vb, vc, cur), reglambda, fixnan)


def triplet_costs_from_positions(va, vb, vc, cp_coords, tables: LevelTables,
                                 reglambda, mu, kappa, k_exp, rexp,
                                 fixnan=False):
    """Strain triplet cost from corner POSITIONS (T,C,3): folding gate vs
    the CURRENT CP grid, strain vs the level-start grid,
    cost = lambda * strain^rexp."""
    t = tables.triplets
    return _strain_costs(va, vb, vc, cp_coords[t], tables.orig_cp[t],
                         reglambda, mu, kappa, k_exp, rexp, fixnan)


def triplet_volume_arrays(rl, trip, cur, orig, reglambda, mu, kappa, k_exp,
                          rexp):
    """(Tc, L^3) strain cost block from explicit per-triplet arrays.
    trip (Tc,3) CP vertex ids into rl; cur/orig (Tc,3,3) current/level-start
    corner coords."""
    L = rl.shape[1]
    ar = torch.arange(L, device=rl.device)
    la = ar.repeat_interleave(L * L)
    lb = ar.repeat_interleave(L).repeat(L)
    lc = ar.repeat(L * L)
    va = rl[trip[:, 0][:, None], la[None, :]]
    vb = rl[trip[:, 1][:, None], lb[None, :]]
    vc = rl[trip[:, 2][:, None], lc[None, :]]
    return _strain_costs(va, vb, vc, cur, orig, reglambda, mu, kappa, k_exp,
                         rexp)


def triplet_cost_volume(rl, cp_coords, tables: LevelTables, reglambda, mu,
                        kappa, k_exp, rexp, tchunk: int = 256):
    """Full (T, L, L, L) strain cost volume for MCMC, built `tchunk`
    triplets at a time (the (3,3) intermediates of T x L^3 entries would
    not fit at once)."""
    L = rl.shape[1]
    t = tables.triplets
    cur = cp_coords[t]
    orig = tables.orig_cp[t]
    out = [triplet_volume_arrays(rl, t[s:s + tchunk], cur[s:s + tchunk],
                                 orig[s:s + tchunk], reglambda, mu, kappa,
                                 k_exp, rexp)
           for s in range(0, t.shape[0], tchunk)]
    return torch.cat(out).reshape(-1, L, L, L)


# --------------------------------------------------------------------------
# pairwise regulariser (regmode 1 / FastPD path)
# --------------------------------------------------------------------------

def pairwise_cost_volume(rl, cp_coords, tables: LevelTables, reglambda, rexp,
                         pchunk: int = 128):
    """(Pr, L, L) rotation-difference regulariser with folding gate
    (computePairwiseCost, DiscreteCostFunction.cpp:190-226).

    Folding is checked on the faces incident to the pair's FIRST node with
    both endpoints moved, against the level-start grid normals (the
    reference's use of _oCPgrid). The (pc,MT,3,L,L,3) gate intermediates
    are built `pchunk` pairs at a time."""
    eps = 1e-8
    rot_node = sph.rodrigues(cp_coords[:, None, :].expand(rl.shape), rl)

    theta_mvd = 2.0 * torch.arcsin(tables.mvd_max / (2.0 * RAD))
    cpf = tables.cp_faces
    nf = cpf.shape[0]
    o_n = sph.tri_normal(tables.orig_cp[cpf[:, 0]], tables.orig_cp[cpf[:, 1]],
                         tables.orig_cp[cpf[:, 2]])    # level-start normals

    out = []
    for s in range(0, tables.pairs.shape[0], pchunk):
        pr = tables.pairs[s:s + pchunk]
        i, j = pr[:, 0], pr[:, 1]                      # (pc,)
        # trace(R1^T R2) over every label pair
        tr = torch.einsum("paij,pbij->pab", rot_node[i], rot_node[j])
        cos_t = ((tr - 1.0) / 2.0).clamp(-1.0, 1.0)
        theta = torch.arccos(cos_t)
        smooth = reglambda * torch.pow(math.sqrt(2.0) * theta / theta_mvd,
                                       rexp)
        active = (1.0 - cos_t).abs() > eps             # rotations differ

        # folding gate: faces incident to node i with endpoints i,j moved,
        # tested against the level-start normals (only when active)
        fidx = tables.cp_tri_idx[i]                    # (pc,MT)
        fsafe = fidx.clamp(0, nf - 1)
        fv = cpf[fsafe]                                # (pc,MT,3v)
        base = cp_coords[fv]                           # (pc,MT,3v,3)
        is_i = (fv == i[:, None, None])[..., None, None, None]
        is_j = (fv == j[:, None, None])[..., None, None, None]
        # corner coords per (pc,MT,3v,La,Lb,3)
        pos = base[:, :, :, None, None, :]
        pos = torch.where(is_i, rl[i][:, None, None, :, None, :], pos)
        pos = torch.where(is_j, rl[j][:, None, None, None, :, :], pos)
        n_new = sph.tri_normal(pos[:, :, 0], pos[:, :, 1], pos[:, :, 2])
        dot = (n_new * o_n[fsafe][:, :, None, None, :]).sum(-1)
        valid = (fidx >= 0)[:, :, None, None]
        fold_any = ((dot < 0.0) & valid).any(dim=1)    # (pc,L,L)
        out.append(torch.where(
            active, torch.where(fold_any, torch.full_like(smooth, FOLDING),
                                smooth), torch.zeros_like(smooth)))
    return torch.cat(out)


# --------------------------------------------------------------------------
# triclique likelihood (--triclique)
# --------------------------------------------------------------------------

def build_face_patches(src_coords, cp_tables: SearchTables, fmax: int):
    """Assign each source vertex to its closest CP-grid face and invert to
    padded per-face index lists (HO get_source_data,
    DiscreteCostFunction.cpp:468-485): a face keeps its first `fmax`
    vertices in vertex order (stable sort).
    Returns (face_idx (F,fmax) int64, mask (F,fmax), overflow (F,))."""
    F = cp_tables.faces.shape[0]
    N = src_coords.shape[0]
    dev = src_coords.device
    face_of = nearest_triangle(src_coords, cp_tables).long()     # (N,)
    f_sorted, order = torch.sort(face_of, stable=True)
    counts = torch.bincount(f_sorted, minlength=F)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(N, device=dev) - starts[f_sorted]
    keep = pos < fmax                                  # beyond fmax: dropped
    flat = (f_sorted * fmax + pos)[keep]               # distinct slots
    idx = torch.zeros(F * fmax, dtype=torch.int64, device=dev)
    mask = torch.zeros(F * fmax, dtype=torch.bool, device=dev)
    idx[flat] = order[keep]
    mask[flat] = True
    return idx.reshape(F, fmax), mask.reshape(F, fmax), counts > fmax


def triclique_likelihood(cp_coords, rl, tables: LevelTables, face_idx,
                         face_mask, src_coords, abs_weights, cfweights,
                         la, lb, lc, simval: int, percentile=0.75,
                         multivariate: bool = False):
    """Triangular-patch likelihood (HO*::triplet_likelihood,
    DiscreteCostFunction.cpp:487-531 / :565-618): project each patch point
    onto the CURRENT CP triangle's plane, re-evaluate its barycentric
    position at the deformed corners, re-project to the sphere, resample the
    target there and compare with the source patch. la/lb/lc: (T,C).
    Returns (T,C)."""
    t = tables.triplets
    src_pts = src_coords[face_idx]                               # (T,Pf,3)

    cp0, cp1, cp2 = (cp_coords[t[:, i]][:, None, :] for i in range(3))
    sp = sph.project_to_plane(src_pts, cp0, cp1, cp2)            # (T,Pf,3)

    # barycentric areas at sp wrt the CURRENT triangle (triangle.cpp:159-172)
    aa = sph.tri_area(sp, cp1, cp2)
    ab = sph.tri_area(sp, cp0, cp2)
    ac = sph.tri_area(sp, cp0, cp1)
    tot = aa + ab + ac
    tot = torch.where(tot > 0, tot, torch.ones_like(tot))
    wa, wb, wc = aa / tot, ab / tot, ac / tot                    # (T,Pf)

    na = rl[t[:, 0][:, None], la]                                # (T,C,3)
    nb = rl[t[:, 1][:, None], lb]
    nc = rl[t[:, 2][:, None], lc]
    newp = (na[:, :, None, :] * wa[:, None, :, None]
            + nb[:, :, None, :] * wb[:, None, :, None]
            + nc[:, :, None, :] * wc[:, None, :, None])          # (T,C,Pf,3)
    newp = sph.normalize(newp) * RAD

    tgt = _resample_target(newp, tables.target_tables,
                           tables.target_data)                   # (T,C,Pf,D)
    src_patch = tables.source_data[:, face_idx]                  # (D,T,Pf)
    w_patch = cfweights[:, face_idx]                             # (Dw,T,Pf)
    m = face_mask.to(tgt.dtype)

    if not multivariate:
        shp = tgt.shape[:3]
        sim = simi.sim_for_min(src_patch[0][:, None, :].expand(shp),
                               tgt[..., 0],
                               w_patch[0][:, None, :].expand(shp),
                               m[:, None, :].expand(shp), simval,
                               percentile)                       # (T,C)
    else:
        D = tgt.shape[-1]
        a = src_patch.permute(1, 2, 0)[:, None].expand(tgt.shape)
        wd = w_patch.permute(1, 2, 0)
        if wd.shape[-1] != D:
            wd = wd[..., :1].expand(wd.shape[:-1] + (D,))
        per_vtx = simi.sim_for_min(a, tgt, wd[:, None].expand(tgt.shape),
                                   torch.ones_like(a), simval, percentile)
        mm = m[:, None, :]
        sim = (per_vtx * mm).sum(-1) / torch.clamp(mm.sum(-1), min=1.0)

    aw = (abs_weights[t[:, 0]] + abs_weights[t[:, 1]]
          + abs_weights[t[:, 2]])[:, None] / 3.0
    return aw * sim


# --------------------------------------------------------------------------
# anatomical (aMSM) regulariser, regmode 5
# --------------------------------------------------------------------------

class AnatTables(NamedTuple):
    """Static aMSM state (resample_anatomy, mesh_registration.cpp:250-332)."""
    lineage: torch.Tensor       # (T, Fd) descendant anat faces per CP face
    anat_faces: torch.Tensor    # (Ta,3) anat-ico faces
    anat_bary: torch.Tensor     # (Va,3) barycentric weights wrt parent CP tri
    anat_parent: torch.Tensor   # (Va,3) CP vertex ids the weights refer to
    anat_sphere: SearchTables   # pristine anat-res sphere (aICO)
    anat_target: torch.Tensor   # (Va,3) reference anatomical coords
    anat_orig: torch.Tensor     # (Va,3) input anatomical coords (resampled)


def anatomical_triplet_costs(cp_coords, rl, tables: LevelTables,
                             anat: AnatTables, la, lb, lc, reglambda, mu,
                             kappa, k_exp, rexp, fixnan=False):
    """regmode 5 triplet cost (computeTripletCost case 4/5 + deform_anatomy,
    DiscreteCostFunction.cpp:169-182,255-301): move anat vertices with the
    deformed CP corners via their subdivision barycentrics, re-project
    through the pristine anat sphere onto the reference anatomy, and average
    the strain of the descendant anatomical faces. Returns (T,C)."""
    t = tables.triplets
    T, C = la.shape
    Fd = anat.lineage.shape[1]

    # folding gate on the CP triangle itself (same as the spherical path)
    va = rl[t[:, 0][:, None], la]
    vb = rl[t[:, 1][:, None], lb]
    vc = rl[t[:, 2][:, None], lc]
    folded = _folded(va, vb, vc, cp_coords[t])

    # anat vertices of the descendant faces: (T,Fd,3v)
    fv = anat.anat_faces[anat.lineage]
    wgt = anat.anat_bary[fv]                         # (T,Fd,3v,3w)
    par = anat.anat_parent[fv]                       # (T,Fd,3v,3w) CP ids

    # each anat vertex moves with its OWN parent face's corners: corners
    # belonging to this triplet take their deformed positions, others stay
    # at the current CP grid. (The reference zeroes mismatched corners via
    # std::map default-construction, a documented bug — deform_anatomy,
    # DiscreteCostFunction.cpp:255-301 "bugs expected"; keeping neighbours
    # fixed is the well-defined completion of the same semantics.)
    newp = cp_coords[par][:, None]                   # (T,1,Fd,3v,3w,3)
    for corner, vdef in ((0, va), (1, vb), (2, vc)):
        is_c = par == t[:, corner][:, None, None, None]      # (T,Fd,3v,3w)
        newp = torch.where(is_c[:, None, ..., None],
                           vdef[:, :, None, None, None, :], newp)
    # (T,C,Fd,3v,3): NOT renormalised (the reference keeps the raw
    # barycentric combination before the sphere lookup)
    newp = (newp * wgt[:, None, ..., None]).sum(-2)

    tv, w = barycentric_coords(newp.reshape(-1, 3), anat.anat_sphere)
    trans = (anat.anat_target[tv] * w[..., None]).sum(1).reshape(
        T, C, Fd, 3, 3)

    orig_b = anat.anat_orig[fv][:, None].expand(trans.shape)  # (T,C,Fd,3v,3)
    strain = triangular_strain(orig_b, trans, mu, kappa, k_exp)  # (T,C,Fd)
    cost = reglambda * torch.pow(strain.mean(-1), rexp)
    return _gated_cost(cost, folded, reglambda, fixnan)
