"""Fusion-moves optimisation (Fusion.h:120-245) with a parallel binary
solve.

Port of newmsm_tpu/reg/optimise/fusion.py. Per candidate label alpha, the
binary "keep current vs switch to alpha" energy (unary + 8-combination
triplet tables, and/or 4-combination pair tables) is minimised by exact parallel coordinate descent (ICM):
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

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ... import resolve_device, trace
from .coloring import color_groups, greedy_color, vertex_coloring_from_faces


class FusionTables(NamedTuple):
    """Static host-built index tables for the fusion solver."""
    groups: tuple                  # per colour, the (G_c,) vertex ids
    vert_tri: torch.Tensor         # (K,MT) incident triplet ids, -1 padded
    vert_tri_corner: torch.Tensor  # (K,MT) own corner position in triplet
    vert_pair: Optional[torch.Tensor] = None      # (K,MP) incident pair ids
    vert_pair_end: Optional[torch.Tensor] = None  # (K,MP) own end (0/1)


def color_group_tensors(groups: np.ndarray, mask: np.ndarray,
                        device) -> tuple:
    """(C,G) padded colour groups + mask -> per-colour id tensors."""
    return tuple(torch.from_numpy(g[m].astype(np.int64)).to(device)
                 for g, m in zip(np.asarray(groups), np.asarray(mask)))


def _incidence_table(members: np.ndarray, nverts: int):
    """members (M,W) vertex ids -> per vertex the padded (K,MI) ids of the
    rows that hold it (-1 padded, in row order) and its column there."""
    lists: list[list[tuple[int, int]]] = [[] for _ in range(nverts)]
    for r, row in enumerate(members):
        for col, v in enumerate(row):
            lists[int(v)].append((r, col))
    width = max(1, max((len(x) for x in lists), default=0))
    ids = np.full((nverts, width), -1, np.int64)
    cols = np.zeros((nverts, width), np.int64)
    for v, lst in enumerate(lists):
        for i, (r, col) in enumerate(lst):
            ids[v, i] = r
            cols[v, i] = col
    return ids, cols


def build_fusion_tables(triplets: np.ndarray, nverts: int,
                        device=None, pairs: np.ndarray | None = None
                        ) -> FusionTables:
    """numpy copy of the JAX package's function (`device` None means cuda).
    With `pairs`, the colouring also separates pair endpoints, and the
    per-vertex pair tables are built."""
    dev = resolve_device(device)
    has_pairs = pairs is not None and len(pairs) > 0
    vert_tri, vert_corner = _incidence_table(triplets, nverts)
    colors = vertex_coloring_from_faces(triplets, nverts)
    if has_pairs:
        adj: list[set[int]] = [set() for _ in range(nverts)]
        for a, b in pairs:
            adj[int(a)].add(int(b))
            adj[int(b)].add(int(a))
        for a, b, c in triplets:
            adj[int(a)].update((int(b), int(c)))
            adj[int(b)].update((int(a), int(c)))
            adj[int(c)].update((int(a), int(b)))
        colors = greedy_color(adj)
    groups, mask = color_groups(colors)
    vp = vpe = None
    if has_pairs:
        vp, vpe = (torch.from_numpy(a).to(dev)
                   for a in _incidence_table(pairs, nverts))
    return FusionTables(
        groups=color_group_tensors(groups, mask, dev),
        vert_tri=torch.from_numpy(vert_tri).to(dev),
        vert_tri_corner=torch.from_numpy(vert_corner).to(dev),
        vert_pair=vp, vert_pair_end=vpe)


# (8,3) bit patterns of the triplet combinations, node0 most significant
_BITS = ((np.arange(8)[:, None] >> np.array([2, 1, 0])) & 1).astype(np.int64)


@trace.cached()
def bits(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_BITS).to(device)


def binary_move_tables(labeling, alpha: int, unary, triplets,
                       triplet_combo_fn: Callable,
                       pairs=None, pair_combo_fn: Optional[Callable] = None):
    """The binary "keep current vs switch to alpha" tables (Fusion.h:
    148-202): per-node unary (u0, u1), the per-triplet 8-combination table
    t8 (bit order node0,node1,node2; 1 = switch) and the per-pair
    4-combination table p4 (bit order end0,end1). t8 / p4 may be None."""
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
    p4 = None
    if pairs is not None and pair_combo_fn is not None:
        curp = labeling[pairs]                          # (Pr,2)
        sw = torch.full_like(curp[:, 0], alpha)
        pa = torch.stack([curp[:, 0], curp[:, 0], sw, sw], dim=1)
        pb = torch.stack([curp[:, 1], sw, curp[:, 1], sw], dim=1)
        p4 = pair_combo_fn(pa, pb)                      # (Pr,4)
    return u0, u1, t8, p4


def _table_sum(table, idx):
    """sum_r table[r, idx[..., r]] for idx (...,R) -> (...)."""
    return torch.gather(table.expand(idx.shape + table.shape[-1:]), -1,
                        idx[..., None])[..., 0].sum(-1)


def binary_energy(x, u0, u1, t8, triplets, p4=None, pairs=None):
    """Binary-subproblem energy at x (...,K) (0=keep, 1=switch) -> (...)."""
    e = torch.where(x == 1, u1, u0).sum(-1)
    if t8 is not None:
        xb = x[..., triplets]                           # (...,T,3)
        e = e + _table_sum(t8, xb[..., 0] * 4 + xb[..., 1] * 2 + xb[..., 2])
    if p4 is not None:
        xp = x[..., pairs]                              # (...,Pr,2)
        e = e + _table_sum(p4, xp[..., 0] * 2 + xp[..., 1])
    return e


def _own_bit(xb, pos):
    """xb (S,G,M,W) binary states, pos (G,M) own column -> (S,G,M)."""
    return torch.gather(xb, 3, pos[None, ..., None].expand(
        xb.shape[:3] + (1,)))[..., 0]


def _binary_icm(x, u0, u1, t8, triplets, tables: FusionTables,
                icm_passes: int, p4=None, pairs=None):
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
                idx0 = base - _own_bit(xb, pc) * w
                idx1 = idx0 + w
                d_t = (t8[it_s, idx1] - t8[it_s, idx0]) * tmask
                delta = delta + d_t.sum(-1)
            if p4 is not None:
                ip = tables.vert_pair[nodes]            # (G,MP)
                pe = tables.vert_pair_end[nodes]
                pmask = ip >= 0
                ip_s = ip.clamp(min=0)
                xp = x[:, pairs[ip_s]]                  # (S,G,MP,2)
                wp = torch.where(pe == 0, 2, 1)
                i0 = xp[..., 0] * 2 + xp[..., 1] - _own_bit(xp, pe) * wp
                i1 = i0 + wp
                d_p = (p4[ip_s, i1] - p4[ip_s, i0]) * pmask
                delta = delta + d_p.sum(-1)
            x[:, nodes] = (delta < 0).to(x.dtype)
    return x


def fusion_binary_solve(labeling, alpha: int, unary, triplets,
                        tables: FusionTables, triplet_combo_fn: Callable,
                        icm_passes: int = 4, n_restarts: int = 2,
                        starts: Optional[torch.Tensor] = None, *,
                        pairs=None, pair_combo_fn: Optional[Callable] = None):
    """Solve one binary fusion move (replaces ELC reduction + FastPD,
    Fusion.h:122-244) by multi-start ICM from keep-all, switch-all, the
    greedy-unary start [u1 < u0] and `starts` ((n_restarts, K) random
    starts). Returns binary x (K,)."""
    u0, u1, t8, p4 = binary_move_tables(labeling, alpha, unary, triplets,
                                        triplet_combo_fn, pairs,
                                        pair_combo_fn)
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
    xs = _binary_icm(x0, u0, u1, t8, triplets, tables, icm_passes, p4, pairs)
    es = binary_energy(xs, u0, u1, t8, triplets, p4, pairs)
    # the keep-all start never increases the energy; prefer the earliest
    # start on ties (argmin returns the first match) so sweeps stay monotone
    return xs[torch.argmin(es)]


def fusion_optimize(labeling, unary, triplets, tables: FusionTables,
                    triplet_combo_fn: Callable, num_labels: int,
                    sweeps: int = 2, icm_passes: int = 4,
                    n_restarts: int = 2,
                    generator: Optional[torch.Generator] = None,
                    random_starts: Optional[Callable] = None, *,
                    pairs=None, pair_combo_fn: Optional[Callable] = None):
    """Fusion sweep: for each sweep x candidate label alpha, solve the binary
    move and accept its flips. unary (L,K); triplet_combo_fn(la,lb,lc)->(T,C);
    pair_combo_fn(pa,pb)->(Pr,C) over `pairs` (Pr,2).
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
        with trace.mark("fusion.move"):
            x = fusion_binary_solve(labeling, alpha, unary, triplets, tables,
                                    triplet_combo_fn, icm_passes, n_restarts,
                                    starts_for(alpha), pairs=pairs,
                                    pair_combo_fn=pair_combo_fn)
            labeling = torch.where(x == 1, torch.full_like(labeling, alpha),
                                   labeling)
    return labeling


def fusion_energy(labeling, unary, triplets, triplet_combo_fn,
                  pairs=None, pair_combo_fn=None):
    """Total energy at a labeling, for driver convergence checks."""
    K = labeling.shape[0]
    total = unary[labeling, torch.arange(K, device=unary.device)].sum()
    if triplets.shape[0] > 0:
        cur = labeling[triplets]
        total = total + triplet_combo_fn(cur[:, 0:1], cur[:, 1:2],
                                         cur[:, 2:3])[:, 0].sum()
    if pairs is not None and pair_combo_fn is not None:
        curp = labeling[pairs]
        total = total + pair_combo_fn(curp[:, 0:1], curp[:, 1:2])[:, 0].sum()
    return total
