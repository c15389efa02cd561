"""Icosphere generation with reference-compatible vertex/face ordering.

The port's own copy of the JAX package's core/icosphere.py, with the face
and vertex loops written as whole-array numpy (no compiled host extension).
Host-side precompute, cached per resolution. The vertex and face
orderings replicate the reference construction (mesh.cpp:1111-1196
``make_mesh_from_icosa`` and ``retessellate`` mesh.cpp:910-1005) so that
control-point indices, data-grid indices and outputs are structurally
interchangeable with the reference implementation. The reference dedups new
midpoints by coordinate equality; midpoints are unique per edge on a convex
sphere, so an edge-keyed dedup is exact and O(T).

All geometry here is float64 numpy; device code converts as needed.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

# vertex counts per resolution level (reference mesh.cpp:810-830)
_RES_TO_NVERT = {0: 12, 1: 42, 2: 162, 3: 642, 4: 2562, 5: 10242, 6: 40962, 7: 163842}
_NVERT_TO_RES = {v: k for k, v in _RES_TO_NVERT.items()}


def resolution_from_nvertices(n: int) -> int:
    """Icosphere level from vertex count (reference mesh.cpp:810-830)."""
    if n not in _NVERT_TO_RES:
        raise ValueError(f"mesh with {n} vertices is not an icosphere")
    return _NVERT_TO_RES[n]


def _base_icosahedron() -> tuple[np.ndarray, np.ndarray]:
    """12-vertex icosahedron in reference vertex/face order (mesh.cpp:1111-1188).

    The reference pushes points ZA..XD then applies ``swap_orientation``
    (vertices 1 and 2 exchanged) to every base face.
    """
    tau = 0.8506508084
    one = 0.5257311121
    pts = np.array(
        [
            [tau, one, 0.0],    # ZA 0
            [-tau, one, 0.0],   # ZB 1
            [-tau, -one, 0.0],  # ZC 2
            [tau, -one, 0.0],   # ZD 3
            [one, 0.0, tau],    # YA 4
            [one, 0.0, -tau],   # YB 5
            [-one, 0.0, -tau],  # YC 6
            [-one, 0.0, tau],   # YD 7
            [0.0, tau, one],    # XA 8
            [0.0, -tau, one],   # XB 9
            [0.0, -tau, -one],  # XC 10
            [0.0, tau, -one],   # XD 11
        ],
        dtype=np.float64,
    )
    ZA, ZB, ZC, ZD, YA, YB, YC, YD, XA, XB, XC, XD = range(12)
    faces = np.array(
        [
            [YD, XA, YA], [XB, YD, YA], [XD, YC, YB], [YC, XC, YB],
            [ZD, YA, ZA], [YB, ZD, ZA], [ZB, YD, ZC], [YC, ZB, ZC],
            [XD, ZA, XA], [ZB, XD, XA], [ZD, XC, XB], [XC, ZC, XB],
            [ZA, YA, XA], [YB, ZA, XD], [ZD, XB, YA], [XC, ZD, YB],
            [ZB, XA, YD], [XD, ZB, YC], [XB, ZC, YD], [ZC, XC, YC],
        ],
        dtype=np.int32,
    )
    faces = faces[:, [0, 2, 1]]  # swap_orientation (triangle.h:55)
    return pts, faces


def _retessellate(coords: np.ndarray, faces: np.ndarray):
    """One 4-to-1 subdivision in reference order (mesh.cpp:910-1005).

    Returns (new_coords, new_faces, lineage) where lineage[t] are the 4 child
    face ids of parent face t, in reference emission order (the variant at
    mesh.cpp:1007-1109 records exactly this for aMSM neighbourhoods).

    Whole-array form of the reference's face loop: a new midpoint vertex is
    numbered by the first appearance of its edge in the sequence
    (face 0: p0, p1, p2; face 1: ...).
    """
    n = coords.shape[0]
    nf = faces.shape[0]
    v0, v1, v2 = (faces[:, i].astype(np.int64) for i in range(3))
    # reference midpoint creation order per face: p0=mid(v1,v2),
    # p1=mid(v0,v2), p2=mid(v0,v1)   (mesh.cpp:929-986)
    ea = np.stack([v1, v0, v0], axis=1).reshape(-1)
    eb = np.stack([v2, v2, v1], axis=1).reshape(-1)
    key = np.minimum(ea, eb) * n + np.maximum(ea, eb)
    _, first, inverse = np.unique(key, return_index=True, return_inverse=True)
    order = np.argsort(first)                 # unique edges, by first use
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    mid = (n + rank[inverse.reshape(-1)]).reshape(nf, 3)
    p0, p1, p2 = mid[:, 0], mid[:, 1], mid[:, 2]
    new_faces = np.stack([
        np.stack([p2, p0, p1], axis=1), np.stack([p1, v0, p2], axis=1),
        np.stack([p0, v2, p1], axis=1), np.stack([p2, v1, p0], axis=1),
    ], axis=1).reshape(nf * 4, 3).astype(np.int32)
    lineage = np.arange(nf * 4, dtype=np.int32).reshape(nf, 4)

    made = first[order]
    out = np.vstack([coords, 0.5 * (coords[ea[made]] + coords[eb[made]])])
    out = out / np.linalg.norm(out, axis=1, keepdims=True)  # mesh.cpp:1003-1004
    return out, new_faces, lineage


def padded_rows(row: np.ndarray, value: np.ndarray, nrows: int, pad=-1):
    """Scatter `value` into a padded (nrows, max_count) int32 table, row by
    `row` (sorted ascending), keeping the given order within a row. `pad`
    is one value or one per row. Returns (table, counts)."""
    cnt = np.bincount(row, minlength=nrows).astype(np.int32)
    start = np.cumsum(cnt) - cnt
    table = np.empty((nrows, int(cnt.max())), dtype=np.int32)
    table[:] = np.reshape(pad, (-1, 1))
    table[row, np.arange(row.size) - start[row]] = value
    return table, cnt


def build_adjacency(faces: np.ndarray, nverts: int):
    """Vertex->neighbour and vertex->incident-face tables from a face list.

    Returns (nbr_idx (N,maxd) int32 padded with -1, nbr_cnt (N,),
             tri_idx (N,maxt) int32 padded with -1, tri_cnt (N,)).
    Incident faces are listed in face-insertion order (matches reference
    Mpoint::trID push order); neighbours in first-encounter order, walking
    the faces in order and, within face (a,b,c), a's (b,c), b's (a,c), c's
    (a,b). Whole-array numpy: sorts over the 3T corners and 6T half-edges.
    """
    f = np.asarray(faces, dtype=np.int64)
    # incident faces: corners grouped by vertex, face ids ascending
    corner = f.reshape(-1)
    order = np.argsort(corner, kind="stable")
    tri_idx, tri_cnt = padded_rows(corner[order], order // 3, nverts)
    # neighbours: the 6 half-edges of a face in encounter order; keep the
    # first occurrence of each (u,v), then order a row by that occurrence
    u = f[:, [0, 0, 1, 1, 2, 2]].reshape(-1)
    v = f[:, [1, 2, 0, 2, 0, 1]].reshape(-1)
    _, first = np.unique(u * nverts + v, return_index=True)
    first = first[np.lexsort((first, u[first]))]
    nbr_idx, nbr_cnt = padded_rows(u[first], v[first], nverts)
    return nbr_idx, nbr_cnt, tri_idx, tri_cnt


@dataclass(frozen=True)
class Icosphere:
    """Immutable icosphere topology + unit-sphere geometry (host arrays)."""

    resolution: int
    coords: np.ndarray        # (N,3) float64, unit radius
    faces: np.ndarray         # (T,3) int32
    nbr_idx: np.ndarray       # (N,6) int32, -1 padded (valence 5 vertices)
    nbr_cnt: np.ndarray       # (N,)
    tri_idx: np.ndarray       # (N,6) int32, -1 padded
    tri_cnt: np.ndarray       # (N,)
    lineages: tuple = field(default=())   # per-subdivision (T_parent,4) child map

    @property
    def nvertices(self) -> int:
        return self.coords.shape[0]

    @property
    def ntriangles(self) -> int:
        return self.faces.shape[0]

    def first_hexavalent_vertex(self) -> int:
        """First vertex with 6 neighbours (sampling-grid centroid,
        DiscreteModel.cpp:114-120)."""
        idx = np.nonzero(self.nbr_cnt == 6)[0]
        if idx.size == 0:
            raise ValueError("icosphere has no 6-valence vertex (resolution 0)")
        return int(idx[0])


@functools.lru_cache(maxsize=None)
def icosphere(resolution: int) -> Icosphere:
    """Icosphere at the given subdivision level, reference-ordered, cached."""
    coords, faces = _base_icosahedron()
    lineages = []
    for _ in range(resolution):
        coords, faces, lin = _retessellate(coords, faces)
        lineages.append(lin)
    nbr_idx, nbr_cnt, tri_idx, tri_cnt = build_adjacency(faces, coords.shape[0])
    return Icosphere(
        resolution=resolution,
        coords=coords,
        faces=faces,
        nbr_idx=nbr_idx,
        nbr_cnt=nbr_cnt,
        tri_idx=tri_idx,
        tri_cnt=tri_cnt,
        lineages=tuple(lineages),
    )


def face_lineage_across(levels_from: int, levels_to: int) -> np.ndarray:
    """Map each face of icosphere(levels_from) to its descendant faces at
    icosphere(levels_to) (reference retessellate-with-lineage chain,
    mesh_registration.cpp:264-294). Returns (T_from, 4**d) int32."""
    if levels_to < levels_from:
        raise ValueError("levels_to must be >= levels_from")
    ico = icosphere(levels_to)
    d = levels_to - levels_from
    t_from = icosphere(levels_from).ntriangles
    cur = np.arange(t_from, dtype=np.int32)[:, None]  # (T,1)
    for lev in range(levels_from, levels_to):
        lin = ico.lineages[lev]  # (T_lev, 4)
        cur = lin[cur].reshape(t_from, -1)
    return cur
