"""Greedy graph colorings of the control-point grid (host-side, cached).

Parallel updates need conflict-free groups: the fusion binary solver and
the unfolder move vertices that share no triplet/face simultaneously.
Icosphere topology gives small, stable chromatic numbers (vertices ~4-7).
The port's own copy of the vertex colouring of the JAX package's
reg/optimise/coloring.py (its face colourings serve optimisers that are
not ported).
"""
from __future__ import annotations

import numpy as np


def greedy_color(adjacency: list[set[int]]) -> np.ndarray:
    n = len(adjacency)
    colors = np.full(n, -1, dtype=np.int32)
    for v in range(n):
        used = {colors[u] for u in adjacency[v] if colors[u] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors


def vertex_coloring_from_faces(faces: np.ndarray, nverts: int) -> np.ndarray:
    """Color vertices so same-color vertices share no face (distance-1 in the
    triplet hypergraph — stronger than edge coloring, required because a
    triplet couples all three corners)."""
    adj: list[set[int]] = [set() for _ in range(nverts)]
    for a, b, c in faces:
        adj[a].update((b, c))
        adj[b].update((a, c))
        adj[c].update((a, b))
    return greedy_color(adj)


def color_groups(colors: np.ndarray, pad_value: int = -1):
    """Split ids by color into a padded (n_colors, max_group) int32 array +
    mask."""
    ncol = int(colors.max()) + 1
    groups = [np.nonzero(colors == c)[0] for c in range(ncol)]
    gmax = max(len(g) for g in groups)
    out = np.full((ncol, gmax), pad_value, dtype=np.int32)
    mask = np.zeros((ncol, gmax), dtype=bool)
    for c, g in enumerate(groups):
        out[c, : len(g)] = g
        mask[c, : len(g)] = True
    return out, mask
