"""Fusion-moves optimisation (Fusion.h:120-245) with a parallel binary
solve.

Port of newmsm_tpu/reg/optimise/fusion.py. Per candidate label alpha, the
binary "keep current vs switch to alpha" energy (unary + 8-combination
triplet tables, and/or 4-combination pair tables) is minimised by exact parallel coordinate descent (ICM):
conflict-free vertex colour groups flip together, each flip judged by its
true local energy delta, from several starts (keep-all, switch-all, the
greedy-unary start and `n_restarts` random starts); the lowest-energy
result wins, the earliest start on ties. `ops.icm.icm_binary` runs every
start's descent and energy: on the card one launch of the hand-written
kernel K2 (csrc/icm_binary.cu), on the CPU its plain version.

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
from ...ops import icm as _icm
from .coloring import color_groups, greedy_color, vertex_coloring_from_faces


class FusionTables(NamedTuple):
    """Static host-built index tables for the fusion solver."""
    groups: tuple                  # per colour, the (G_c,) vertex ids
    color_ids: torch.Tensor        # (sum G_c,) int32: the groups, flat
    color_offsets: torch.Tensor    # (C+1,) int32: where each group starts
    vert_tri: torch.Tensor         # (K,MT) incident triplet ids, -1 padded
    vert_tri_corner: torch.Tensor  # (K,MT) own corner position in triplet
    vert_pair: Optional[torch.Tensor] = None      # (K,MP) incident pair ids
    vert_pair_end: Optional[torch.Tensor] = None  # (K,MP) own end (0/1)


def color_tables(groups, device) -> dict:
    """Per-colour vertex ids (numpy) -> the colour fields of the fusion
    tables: `groups`, one int64 id tensor a colour (the form the plain
    ICM steps through), and `color_ids` / `color_offsets`, their int32
    concatenation and (C+1,) start offsets (the form K2 reads)."""
    groups = [np.asarray(g, np.int64) for g in groups]
    flat = np.concatenate(groups) if groups else np.zeros(0, np.int64)
    offsets = np.cumsum([0] + [len(g) for g in groups])
    return dict(groups=tuple(torch.from_numpy(g).to(device) for g in groups),
                color_ids=torch.from_numpy(flat.astype(np.int32)).to(device),
                color_offsets=torch.from_numpy(
                    offsets.astype(np.int32)).to(device))


def color_group_tensors(groups: np.ndarray, mask: np.ndarray,
                        device) -> dict:
    """(C,G) padded colour groups + mask -> `color_tables`."""
    return color_tables([g[m] for g, m in zip(np.asarray(groups),
                                              np.asarray(mask))], device)


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
        **color_group_tensors(groups, mask, dev),
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
    xs, es = _icm.icm_binary(x0, u0, u1, t8, triplets, tables, icm_passes,
                             p4, pairs)
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
