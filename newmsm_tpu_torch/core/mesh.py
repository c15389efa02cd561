"""Struct-of-arrays surface mesh container (host side).

Replaces the reference's pointer-based Mesh/Mpoint/Triangle object graph
(mesh.h, mpoint.h, triangle.h) with plain numpy arrays:

    coords : (N,3) float64 vertex positions
    faces  : (T,3) int32 vertex indices
    data   : (D,N) float64 per-vertex feature rows (reference `pvalues`)

Device code consumes these arrays directly (converted to f32 on upload).
Adjacency tables are built lazily and cached. The port's own copy of the
JAX package's core/mesh.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .. import EPSILON, RAD
from .icosphere import build_adjacency, icosphere, resolution_from_nvertices


@dataclass
class Mesh:
    coords: np.ndarray                  # (N,3) float64
    faces: np.ndarray                   # (T,3) int32
    data: Optional[np.ndarray] = None   # (D,N) float64
    _adj: Optional[tuple] = field(default=None, repr=False, compare=False)

    # --- construction -----------------------------------------------------
    @classmethod
    def from_icosphere(cls, resolution: int, rad: float = RAD) -> "Mesh":
        """Icosphere mesh rescaled to radius `rad` with one zero data row
        (make_mesh_from_icosa pushes a zero pvalue row, mesh.cpp:1192-1193)."""
        ico = icosphere(resolution)
        coords = ico.coords * rad
        return cls(coords=coords.copy(), faces=ico.faces.copy(),
                   data=np.zeros((1, coords.shape[0])))

    def copy(self) -> "Mesh":
        return Mesh(self.coords.copy(), self.faces,
                    None if self.data is None else self.data.copy(), self._adj)

    # --- basic properties -------------------------------------------------
    @property
    def nvertices(self) -> int:
        return self.coords.shape[0]

    @property
    def ntriangles(self) -> int:
        return self.faces.shape[0]

    @property
    def dimension(self) -> int:
        return 0 if self.data is None else self.data.shape[0]

    def get_resolution(self) -> int:
        return resolution_from_nvertices(self.nvertices)

    # --- adjacency --------------------------------------------------------
    @property
    def adjacency(self):
        """(nbr_idx, nbr_cnt, tri_idx, tri_cnt), cached. For icospheres the
        cached global topology is reused."""
        if self._adj is None:
            try:
                res = self.get_resolution()
                ico = icosphere(res)
                if np.array_equal(ico.faces, self.faces):
                    self._adj = (ico.nbr_idx, ico.nbr_cnt, ico.tri_idx, ico.tri_cnt)
                    return self._adj
            except ValueError:
                pass
            self._adj = build_adjacency(self.faces, self.nvertices)
        return self._adj

    # --- geometry (reference mesh.cpp utilities) --------------------------
    def estimate_origin(self) -> np.ndarray:
        """Sphere-centre estimate from 4 sampled vertices via determinant
        minors (mesh.cpp:832-897)."""
        n = self.nvertices
        p = np.stack([self.coords[n // i - 1] for i in range(1, 5)])  # (4,3)
        sq = np.sum(p * p, axis=1)
        ones = np.ones(4)

        def det4(c1, c2, c3, c4):
            return np.linalg.det(np.stack([c1, c2, c3, c4], axis=1))

        m11 = det4(p[:, 0], p[:, 1], p[:, 2], ones)
        m12 = det4(sq, p[:, 1], p[:, 2], ones)
        m13 = det4(sq, p[:, 0], p[:, 2], ones)
        m14 = det4(sq, p[:, 0], p[:, 1], ones)
        if m11 == 0.0:
            return np.zeros(3)
        return np.array([0.5 * m12 / m11, -0.5 * m13 / m11, 0.5 * m14 / m11])

    def recentre(self) -> None:
        """(mesh.cpp:1221-1255): translate so estimated origin is at 0 (skips
        exact-zero vertices as the reference does)."""
        mean = self.estimate_origin()
        if np.linalg.norm(mean) > 1e-2:
            nonzero = np.linalg.norm(self.coords, axis=1) != 0.0
            self.coords[nonzero] -= mean

    def true_rescale(self, rad: float = RAD) -> None:
        """Normalise all vertices to radius `rad` (mesh.cpp:1210-1219)."""
        norms = np.linalg.norm(self.coords, axis=1, keepdims=True)
        safe = np.where(norms > EPSILON, norms, 1.0)
        self.coords = self.coords / safe * rad

    def check_scale(self, ref: "Mesh") -> None:
        """Rescale self to ref's radius when radii are inconsistent
        (mesh.cpp:1198-1208)."""
        r0 = np.linalg.norm(self.coords[0])
        r1 = np.linalg.norm(self.coords[1])
        r2 = np.linalg.norm(ref.coords[1])
        if abs(r0 - r1) > 1e-3 or abs(r0 - r2) > 1e-3 or abs(r1 - r2) > 1e-3:
            self.true_rescale(r2)

    def triangle_areas(self) -> np.ndarray:
        v0 = self.coords[self.faces[:, 0]]
        v1 = self.coords[self.faces[:, 1]]
        v2 = self.coords[self.faces[:, 2]]
        return 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)

    def triangle_normals(self) -> np.ndarray:
        """Reference orientation: normalize((v2-v0) x (v1-v0))."""
        v0 = self.coords[self.faces[:, 0]]
        v1 = self.coords[self.faces[:, 1]]
        v2 = self.coords[self.faces[:, 2]]
        n = np.cross(v2 - v0, v1 - v0)
        ln = np.linalg.norm(n, axis=1, keepdims=True)
        return n / np.where(ln > EPSILON, ln, 1.0)

    def vertex_normals(self) -> np.ndarray:
        """local_normal per vertex: normalised mean of incident face normals
        (mesh.cpp:133-150)."""
        fn = self.triangle_normals()
        _, _, tri_idx, tri_cnt = self.adjacency
        gathered = fn[np.where(tri_idx >= 0, tri_idx, 0)]
        gathered = gathered * (tri_idx >= 0)[..., None]
        v = gathered.sum(axis=1)
        ln = np.linalg.norm(v, axis=1, keepdims=True)
        return v / np.where(ln > EPSILON, ln, 1.0)

    def vertex_area(self) -> np.ndarray:
        """compute_vertex_area (mesh.cpp:1275-1283): mean incident triangle
        area per vertex."""
        areas = self.triangle_areas()
        _, _, tri_idx, tri_cnt = self.adjacency
        gathered = areas[np.where(tri_idx >= 0, tri_idx, 0)] * (tri_idx >= 0)
        return gathered.sum(axis=1) / np.maximum(tri_cnt, 1)

    def calculate_MaxVD(self) -> float:
        """Max geodesic neighbour distance (mesh.cpp:260-274)."""
        nbr_idx, nbr_cnt, _, _ = self.adjacency
        c = self.coords
        nb = c[np.where(nbr_idx >= 0, nbr_idx, 0)]
        chord = np.linalg.norm(nb - c[:, None, :], axis=2)
        dist = 2 * RAD * np.arcsin(np.clip(chord / (2 * RAD), -1, 1))
        dist = np.where(nbr_idx >= 0, dist, -np.inf)
        return float(dist.max())

    def calculate_MeanVD(self) -> float:
        """Mean chordal neighbour distance (mesh.cpp:276-294)."""
        nbr_idx, nbr_cnt, _, _ = self.adjacency
        c = self.coords
        nb = c[np.where(nbr_idx >= 0, nbr_idx, 0)]
        chord = np.linalg.norm(nb - c[:, None, :], axis=2)
        mask = nbr_idx >= 0
        return float(chord[mask].sum() / mask.sum())

    def max_vertex_distances(self) -> np.ndarray:
        """Per-vertex max geodesic neighbour spacing, vMAXmvd
        (DiscreteModel.cpp:72-85). Returns (N,)."""
        nbr_idx, _, _, _ = self.adjacency
        c = self.coords
        nb = c[np.where(nbr_idx >= 0, nbr_idx, 0)]
        chord = np.linalg.norm(nb - c[:, None, :], axis=2)
        dist = 2 * RAD * np.arcsin(np.clip(chord / (2 * RAD), -1, 1))
        dist = np.where(nbr_idx >= 0, dist, 0.0)
        return dist.max(axis=1)

    # --- data -------------------------------------------------------------
    def set_data(self, data: np.ndarray) -> None:
        data = np.atleast_2d(np.asarray(data, dtype=np.float64))
        if data.shape[1] != self.nvertices:
            if data.shape[0] == self.nvertices:
                data = data.T
            else:
                raise ValueError("data does not match mesh dimensions")
        self.data = data

    # --- I/O (dispatch in core.io) ---------------------------------------
    def save(self, filename: str) -> None:
        from . import io as _io
        _io.save_mesh(self, filename)

    @classmethod
    def load(cls, filename: str) -> "Mesh":
        from . import io as _io
        return _io.load_mesh(filename)


def create_exclusion(mesh: Mesh, thrl: float, thru: float) -> np.ndarray:
    """Exclusion mask from thresholds (mesh.cpp:1257-1273): 1.0 where ANY
    feature dimension falls outside [thrl,thru], else 0. Returns (N,).

    Note reference semantics downstream treat nonzero == *usable* when
    applied as `EXCL->get_pvalue(i) != 0` weighting; the mask marks vertices
    whose data is outside the cut range (i.e. valid cortex, since the cut is
    encoded as values inside the threshold band)."""
    if mesh.data is None:
        raise ValueError("mesh has no data")
    inside = (mesh.data >= (thrl - EPSILON)) & (mesh.data <= (thru + EPSILON))
    return (~inside).any(axis=0).astype(np.float64)
