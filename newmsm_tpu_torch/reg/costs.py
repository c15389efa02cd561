"""MRF cost volumes for discrete surface registration, on the HOCR /
triplet-strain path.

Port of the parts of newmsm_tpu/reg/costs.py that path runs:

  unary    (K, L)   patch rotate -> pristine locate (the CUDA kernel) ->
                    barycentric target gather -> similarity
  triplet  (T, C)   folding gate + closed-form strain

The exact target gather is used throughout (the JAX package's blocked
gather, ops/blocked.py, exists for the TPU's gather rate and is not
ported). Host helpers (`_ball_table_np`, `_ball_cover_np`,
`patch_candidate_ball`, `max_inrange_count`) are numpy copies: the JAX
module cannot be imported without JAX.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import FIX_NAN, FOLDING, RAD
from ..core import spherical as sph
from ..ops import similarity as simi
from ..ops.nearest import (SearchTables, _bfs_ball, _search,
                           resample_pristine_soa)
from ..ops.strain import triangular_strain

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
    maxsep: torch.Tensor            # (K,) per-CP max spacing (level init)


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


@functools.lru_cache(maxsize=None)
def _ball_table_np(res: int, n_centres: int, depth: int):
    """(n_centres, C) graph-ball candidate table on the pristine level-`res`
    icosphere, -1 padded (CP ids are a prefix of the fine ids)."""
    from newmsm_tpu.core.icosphere import icosphere
    tab = _bfs_ball(icosphere(res).nbr_idx, n_centres, depth)
    # self-padding duplicates -> -1 (they would double-count in the sims)
    eq = tab == np.arange(n_centres, dtype=tab.dtype)[:, None]
    tab = tab.copy()
    tab[eq & (np.cumsum(eq, axis=1) > 1)] = -1
    return tab


@functools.lru_cache(maxsize=None)
def _ball_cover_np(res: int, n_centres: int, depth: int) -> float:
    """Certified pristine cover radius of `_ball_table_np`: the minimum over
    centres of the arc distance to the nearest non-ball vertex."""
    from newmsm_tpu.core.icosphere import icosphere
    tab = _ball_table_np(res, n_centres, depth)
    u = icosphere(res).coords.astype(np.float64)
    cover = np.inf
    for s in range(0, n_centres, 256):
        e = min(s + 256, n_centres)
        dist = RAD * np.arccos(np.clip(u[s:e] @ u.T, -1.0, 1.0))
        t = tab[s:e]
        rr, cc = np.nonzero(t >= 0)
        dist[rr, t[rr, cc]] = np.inf
        cover = min(cover, float(dist.min()))
    return cover


def patch_candidate_ball(cp_coords, src_coords, faces, limits, rad=RAD):
    """Host-side: a candidate ball table for `build_patches` whose
    exactness certificate holds (see the JAX original for the bound), or
    None (caller then uses the dense path)."""
    from newmsm_tpu.core.icosphere import _NVERT_TO_RES, icosphere
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
    for depth in (4, 6, 8, 10, 12, 14, 16):
        if _ball_cover_np(res, K, depth) > r_req:
            tab = _ball_table_np(res, K, depth)
            return None if tab.shape[1] >= N // 2 else tab
    return None


def max_inrange_count(cp_coords, src_coords, limits, rad=RAD,
                      chunk=512) -> int:
    """Host-side exact max over CPs of the in-range source-vertex count
    (sizes the pmax patch capacity)."""
    cp_coords = np.asarray(cp_coords, np.float64)
    src_coords = np.asarray(src_coords, np.float64)
    uc = cp_coords / np.linalg.norm(cp_coords, axis=1, keepdims=True)
    uv = src_coords / np.linalg.norm(src_coords, axis=1, keepdims=True)
    lim = np.asarray(limits, np.float64)
    best = 0
    for s in range(0, len(uc), chunk):
        d = rad * np.arccos(np.clip(uc[s:s + chunk] @ uv.T, -1.0, 1.0))
        best = max(best, int((d < lim[s:s + chunk, None]).sum(1).max()))
    return best


def rotated_label_positions(cp_coords, labels, centre):
    """RL[k,l] = R(centre -> CP_k) @ label_l (DiscreteModel.cpp:310-319).
    Returns (rots (K,3,3), rl (K,L,3))."""
    rots = sph.rodrigues(centre.expand(cp_coords.shape), cp_coords)
    return rots, torch.einsum("kij,lj->kli", rots, labels)


# --------------------------------------------------------------------------
# unary data term
# --------------------------------------------------------------------------

def _resample_target(points, tables: SearchTables, target_data):
    """Barycentric-interpolate target data at points (...,3) -> (..., D)
    through the general search (deformed targets)."""
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
    of per-vertex feature-vector sims (:385-458). rl (K,L,3) rotated label
    positions; cfweights (Dw,N) source weighting (Dw == 1 or D)."""
    if mode not in ("univariate", "multivariate"):
        raise NotImplementedError(f"unary mode {mode!r} is not ported yet "
                                  "(ROADMAP.md queue 1)")
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


def triplet_costs_from_positions(va, vb, vc, cp_coords, tables: LevelTables,
                                 reglambda, mu, kappa, k_exp, rexp,
                                 fixnan=False):
    """Strain triplet cost from corner POSITIONS (T,C,3): folding gate vs
    the CURRENT CP grid, strain vs the level-start grid,
    cost = lambda * strain^rexp."""
    t = tables.triplets
    cur = cp_coords[t]                                 # (T,3,3)
    n_cur = sph.tri_normal(cur[:, 0], cur[:, 1], cur[:, 2])
    n_def = sph.tri_normal(va, vb, vc)
    folded = (n_def * n_cur[:, None, :]).sum(-1) < 0.0

    orig_b = tables.orig_cp[t][:, None].expand(va.shape[:2] + (3, 3))
    deformed = torch.stack([va, vb, vc], dim=-2)
    strain = triangular_strain(orig_b, deformed, mu, kappa, k_exp)
    cost = reglambda * torch.pow(strain, rexp)
    if fixnan:
        cost = torch.where(torch.isnan(cost), torch.full_like(cost, FIX_NAN),
                           cost)
    return torch.where(folded, torch.full_like(cost, FOLDING * reglambda),
                       cost)
