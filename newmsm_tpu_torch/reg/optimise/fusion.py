"""Fusion-moves optimisation (Fusion.h:120-245) with a parallel binary
solve, on the triplet (HOCR) path.

Port of newmsm_tpu/reg/optimise/fusion.py. Per candidate label alpha, the
binary "keep current vs switch to alpha" energy (unary + 8-combination
triplet tables) is minimised by exact parallel coordinate descent (ICM):
conflict-free vertex colour groups flip together, each flip judged by its
true local energy delta, from several starts (keep-all, switch-all, the
greedy-unary start and `n_restarts` random starts); the lowest-energy
result wins, the earliest start on ties.

Random starts: the JAX package draws them from jax.random (threefry), which
torch cannot reproduce. Here they come from an explicit torch.Generator,
drawn once per alpha so that, as in the JAX package, an alpha's starts are
the same in every sweep; `random_starts` (alpha -> (n_restarts, K) int
tensor) injects them instead, which lets a test feed both packages the
same starts.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ... import resolve_device
from .coloring import color_groups, vertex_coloring_from_faces


class FusionTables(NamedTuple):
    """Static host-built index tables for the fusion solver."""
    groups: tuple                  # per colour, the (G_c,) vertex ids
    vert_tri: torch.Tensor         # (K,MT) incident triplet ids, -1 padded
    vert_tri_corner: torch.Tensor  # (K,MT) own corner position in triplet


def color_group_tensors(groups: np.ndarray, mask: np.ndarray,
                        device) -> tuple:
    """(C,G) padded colour groups + mask -> per-colour id tensors."""
    return tuple(torch.from_numpy(g[m].astype(np.int64)).to(device)
                 for g, m in zip(np.asarray(groups), np.asarray(mask)))


def build_fusion_tables(triplets: np.ndarray, nverts: int,
                        device=None) -> FusionTables:
    """numpy copy of the JAX package's function, triplet path only
    (`device` None means cuda)."""
    dev = resolve_device(device)
    vt: list[list[tuple[int, int]]] = [[] for _ in range(nverts)]
    for t, tri in enumerate(triplets):
        for corner, v in enumerate(tri):
            vt[int(v)].append((t, corner))
    mt = max(1, max(len(x) for x in vt))
    vert_tri = np.full((nverts, mt), -1, np.int64)
    vert_corner = np.zeros((nverts, mt), np.int64)
    for v, lst in enumerate(vt):
        for i, (t, c) in enumerate(lst):
            vert_tri[v, i] = t
            vert_corner[v, i] = c
    groups, mask = color_groups(vertex_coloring_from_faces(triplets, nverts))
    return FusionTables(
        groups=color_group_tensors(groups, mask, dev),
        vert_tri=torch.from_numpy(vert_tri).to(dev),
        vert_tri_corner=torch.from_numpy(vert_corner).to(dev))


# (8,3) bit patterns of the triplet combinations, node0 most significant
_BITS = ((np.arange(8)[:, None] >> np.array([2, 1, 0])) & 1).astype(np.int64)


@functools.lru_cache(maxsize=None)
def bits(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_BITS).to(device)


def binary_move_tables(labeling, alpha: int, unary, triplets,
                       triplet_combo_fn: Callable):
    """The binary "keep current vs switch to alpha" tables (Fusion.h:
    148-202): per-node unary (u0, u1) and the per-triplet 8-combination
    table t8 (bit order node0,node1,node2; 1 = switch), or None."""
    K = labeling.shape[0]
    ar = torch.arange(K, device=unary.device)
    u0 = unary[labeling, ar]
    u1 = unary[alpha, ar]
    t8 = None
    if triplets.shape[0] > 0:
        cur = labeling[triplets]                        # (T,3)
        fast = getattr(triplet_combo_fn, "binary_fast", None)
        if fast is not None:
            t8 = fast(cur, alpha)                       # (T,8)
        else:
            b = bits(unary.device)
            la, lb, lc = (torch.where(b[None, :, i] == 1,
                                      torch.full_like(cur[:, i:i + 1], alpha),
                                      cur[:, i:i + 1]) for i in range(3))
            t8 = triplet_combo_fn(la, lb, lc)
    return u0, u1, t8


def binary_energy(x, u0, u1, t8, triplets):
    """Binary-subproblem energy at x (...,K) (0=keep, 1=switch) -> (...)."""
    e = torch.where(x == 1, u1, u0).sum(-1)
    if t8 is not None:
        xb = x[..., triplets]                           # (...,T,3)
        idx = xb[..., 0] * 4 + xb[..., 1] * 2 + xb[..., 2]
        e = e + torch.gather(t8.expand(idx.shape + (8,)), -1,
                             idx[..., None])[..., 0].sum(-1)
    return e


def _binary_icm(x, u0, u1, t8, triplets, tables: FusionTables,
                icm_passes: int):
    """Exact parallel coordinate descent on the binary move energy from the
    starts x (S,K): colour groups flip together, each flip judged by its
    true local energy delta. Monotone non-increasing per start."""
    for _ in range(icm_passes):
        for nodes in tables.groups:
            delta = (u1[nodes] - u0[nodes])[None].expand(x.shape[0], -1)
            if t8 is not None:
                it = tables.vert_tri[nodes]             # (G,MT)
                pc = tables.vert_tri_corner[nodes]
                tmask = it >= 0
                it_s = it.clamp(min=0)
                xb = x[:, triplets[it_s]]               # (S,G,MT,3)
                base = xb[..., 0] * 4 + xb[..., 1] * 2 + xb[..., 2]
                w = torch.where(pc == 0, 4, torch.where(pc == 1, 2, 1))
                own = torch.gather(xb, 3, pc[None, ..., None].expand(
                    xb.shape[:3] + (1,)))[..., 0]
                idx0 = base - own * w
                idx1 = idx0 + w
                d_t = (t8[it_s, idx1] - t8[it_s, idx0]) * tmask
                delta = delta + d_t.sum(-1)
            x[:, nodes] = (delta < 0).to(x.dtype)
    return x


def fusion_binary_solve(labeling, alpha: int, unary, triplets,
                        tables: FusionTables, triplet_combo_fn: Callable,
                        icm_passes: int = 4, n_restarts: int = 2,
                        starts: Optional[torch.Tensor] = None):
    """Solve one binary fusion move (replaces ELC reduction + FastPD,
    Fusion.h:122-244) by multi-start ICM from keep-all, switch-all, the
    greedy-unary start [u1 < u0] and `starts` ((n_restarts, K) random
    starts). Returns binary x (K,)."""
    u0, u1, t8 = binary_move_tables(labeling, alpha, unary, triplets,
                                    triplet_combo_fn)
    K = labeling.shape[0]
    x0 = [torch.zeros(K, dtype=torch.int64, device=unary.device),
          torch.ones(K, dtype=torch.int64, device=unary.device),
          (u1 < u0).to(torch.int64)]
    x0 = torch.stack(x0)
    if n_restarts > 0:
        if starts is None or tuple(starts.shape) != (n_restarts, K):
            raise ValueError(f"fusion_binary_solve: {n_restarts} random "
                             f"starts of length {K} required")
        x0 = torch.cat([x0, starts.to(device=unary.device,
                                      dtype=torch.int64)])
    xs = _binary_icm(x0, u0, u1, t8, triplets, tables, icm_passes)
    es = binary_energy(xs, u0, u1, t8, triplets)
    # the keep-all start never increases the energy; prefer the earliest
    # start on ties (argmin returns the first match) so sweeps stay monotone
    return xs[torch.argmin(es)]


def fusion_optimize(labeling, unary, triplets, tables: FusionTables,
                    triplet_combo_fn: Callable, num_labels: int,
                    sweeps: int = 2, icm_passes: int = 4,
                    n_restarts: int = 2,
                    generator: Optional[torch.Generator] = None,
                    random_starts: Optional[Callable] = None):
    """Fusion sweep: for each sweep x candidate label alpha, solve the binary
    move and accept its flips. unary (L,K); triplet_combo_fn(la,lb,lc)->(T,C).
    Random starts come from `random_starts(alpha)` when given, else from
    `generator` (drawn on the host, once per alpha, then moved to the
    device). Returns the new labeling."""
    K = labeling.shape[0]
    cache: dict = {}

    def starts_for(alpha):
        if n_restarts == 0:
            return None
        if random_starts is not None:
            return random_starts(alpha)
        if alpha not in cache:
            if generator is None:
                raise ValueError("fusion_optimize: a torch.Generator or "
                                 "random_starts is required for random "
                                 "restarts")
            cache[alpha] = torch.randint(0, 2, (n_restarts, K),
                                         generator=generator)
        return cache[alpha]

    for i in range(sweeps * num_labels):
        alpha = i % num_labels
        x = fusion_binary_solve(labeling, alpha, unary, triplets, tables,
                                triplet_combo_fn, icm_passes, n_restarts,
                                starts_for(alpha))
        labeling = torch.where(x == 1, torch.full_like(labeling, alpha),
                               labeling)
    return labeling


def fusion_energy(labeling, unary, triplets, triplet_combo_fn):
    """Total energy at a labeling, for driver convergence checks."""
    K = labeling.shape[0]
    total = unary[labeling, torch.arange(K, device=unary.device)].sum()
    if triplets.shape[0] > 0:
        cur = labeling[triplets]
        total = total + triplet_combo_fn(cur[:, 0:1], cur[:, 1:2],
                                         cur[:, 2:3])[:, 0].sum()
    return total
