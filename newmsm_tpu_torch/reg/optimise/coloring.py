"""Greedy graph colorings of the control-point grid (host-side, cached).

Parallel label updates need conflict-free groups: MCMC processes triplets
whose vertex sets are disjoint simultaneously; the fusion binary solver and
the unfolder move vertices that share no triplet/edge simultaneously.
Icosphere topology gives small, stable chromatic numbers (faces ~8-12,
vertices ~4-7). The port's own copy of the JAX package's
reg/optimise/coloring.py; the face colouring (DSATUR) runs on whole arrays
with the same vertex order and tie-breaks, so its colours are equal.
"""
from __future__ import annotations

import numpy as np
from scipy import sparse


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


def dsatur_color(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """DSATUR colouring of a graph in CSR form (row v's neighbours are
    indices[indptr[v]:indptr[v+1]]): colour next the uncoloured vertex with
    the most distinct neighbour colours, then the highest degree, then the
    lowest id; give it the lowest colour no neighbour has. Fewer colours
    than plain greedy (9 vs 11 for icosphere face conflicts), and every
    colour saved is one fewer sequential step per optimiser sweep."""
    n = len(indptr) - 1
    deg = np.diff(indptr).astype(np.int64)
    colors = np.full(n, -1, dtype=np.int32)
    # sat[v, c]: some neighbour of v has colour c (at most max degree + 1)
    sat = np.zeros((n, int(deg.max(initial=0)) + 1), dtype=bool)
    # one integer orders (saturation, degree); argmax takes the lowest id
    key = deg.copy()
    stride = int(deg.max(initial=0)) + 1
    for _ in range(n):
        v = int(np.argmax(key))
        c = int(np.argmin(sat[v]))
        colors[v] = c
        key[v] = -1
        nb = indices[indptr[v]:indptr[v + 1]]
        new = nb[~sat[nb, c] & (colors[nb] < 0)]
        sat[nb, c] = True
        key[new] += stride
    return colors


def face_coloring(faces: np.ndarray, nverts: int) -> np.ndarray:
    """Color faces so same-color faces share no vertex."""
    faces = np.asarray(faces)
    nf = len(faces)
    inc = sparse.csr_matrix(
        (np.ones(3 * nf, np.int32),
         (np.repeat(np.arange(nf), 3), faces.reshape(-1))),
        shape=(nf, nverts))
    adj = (inc @ inc.T).tocsr()
    adj.setdiag(0)
    adj.eliminate_zeros()
    adj.sort_indices()
    return dsatur_color(adj.indptr, adj.indices)


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
