"""Label sampling grid: candidate displacement positions around a sampling-
grid centroid (DiscreteModel.cpp:110-214).

Host-side float64 precompute, replicating the reference's BFS collection
including its dedup semantics: samples are keyed by distance in a sorted map
(equal distances collapse), barycentres are deduped by direction (1e-2
collinearity tolerance). Labels are ordered [centre, then by distance].
The port's own copy of the JAX package's reg/sampling_grid.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import RAD
from ..core.icosphere import icosphere


@dataclass(frozen=True)
class SamplingGrid:
    centre: np.ndarray        # (3,)
    samples: np.ndarray       # (Ls,3) vertex-position labels
    barycentres: np.ndarray   # (Lb,3) face-barycentre labels


def build_sampling_grid(sg_res: int, max_distance: float) -> SamplingGrid:
    """BFS over the icosphere at `sg_res` from its first 6-valence vertex,
    collecting vertices and face barycentres within `max_distance` (chordal)
    of the centroid (label_sampling_grid, DiscreteModel.cpp:124-190)."""
    ico = icosphere(sg_res)
    coords = ico.coords * RAD
    centroid = ico.first_hexavalent_vertex()
    centre = coords[centroid]

    samples: dict[float, np.ndarray] = {}
    barycentres: dict[float, np.ndarray] = {}
    found_v = np.zeros(ico.nvertices, bool)
    found_t = np.zeros(ico.ntriangles, bool)

    frontier = [centroid]
    while frontier:
        next_frontier = []
        for v in frontier:
            for n in ico.nbr_idx[v]:
                if n < 0:
                    continue
                sample = coords[n]
                dist = float(np.linalg.norm(sample - centre))
                if dist <= max_distance and not found_v[n] and n != centroid:
                    samples[dist] = sample        # map semantics: ties overwrite
                    next_frontier.append(int(n))
                    found_v[n] = True
            for t in ico.tri_idx[v]:
                if t < 0 or found_t[t]:
                    continue
                tv = coords[ico.faces[t]]
                bary = tv.mean(axis=0)
                bary = bary / np.linalg.norm(bary) * RAD
                dist = float(np.linalg.norm(bary - centre))
                if dist <= max_distance and dist > 0:
                    # dedup by direction (DiscreteModel.cpp:169-175)
                    d = bary - centre
                    duplicate = False
                    for b in barycentres.values():
                        db = b - centre
                        denom = np.linalg.norm(d) * np.linalg.norm(db)
                        if denom > 0 and abs(1 - np.dot(d, db) / denom) < 1e-2:
                            duplicate = True
                            break
                    if not duplicate:
                        barycentres[dist] = bary
                    found_t[t] = True
        frontier = next_frontier

    s = np.stack([centre] + [samples[k] for k in sorted(samples)]) if samples else centre[None]
    b = np.stack([centre] + [barycentres[k] for k in sorted(barycentres)]) if barycentres else centre[None]
    return SamplingGrid(centre=centre, samples=s, barycentres=b)


def rescale_labels(grid: SamplingGrid, base: np.ndarray, scale: float) -> np.ndarray:
    """rescale_sampling_grid step (DiscreteModel.cpp:192-214): shrink labels
    towards the centre by `scale` (note the reference computes
    centre + (centre - sample)*scale, a point REFLECTION scaling —
    reproduced faithfully), re-projected to the sphere."""
    c = grid.centre
    out = c[None, :] + (c[None, :] - base) * scale
    out = out / np.linalg.norm(out, axis=1, keepdims=True) * RAD
    return out
