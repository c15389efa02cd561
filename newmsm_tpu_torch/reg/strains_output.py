"""Vertex-wise principal strain maps (calculate_strains,
reg_tools.cpp:365-549): quadratic surface fit around each vertex, deformation
gradient in curvilinear coordinates, principal stretches from the right
Cauchy-Green tensor (excluding the surface-normal direction).

Output-path only (the hot path uses the closed-form triangle strain), so this
runs host-side in float64 for numerical parity with the reference's NEWMAT
SVD chain. The port's own copy of the JAX package's reg/strains_output.py.

The vectorised path gathers each vertex's candidates by k-NN (covers the
reference's fit radius on any registration-grade mesh), batches the tangent
bases, quadratic fits (pseudo-inverse via batched SVD) and 3x3
eigendecompositions, and falls back to the reference-shaped loop only for
vertices whose fit radius had to grow beyond the candidate set (rare).
`tests/test_torch_amsm.py` pins the two paths equal.
"""
from __future__ import annotations

import numpy as np

import torch

from ..core import spherical as sph
from ..core.mesh import Mesh


def _tangs_batch(normals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    e1, e2 = sph.vertex_tangent_basis(
        torch.from_numpy(np.ascontiguousarray(normals, np.float64)))
    return e1.numpy(), e2.numpy()


def _tangs(normal: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    e1, e2 = _tangs_batch(normal[None])
    return e1[0], e2[0]


def _vertex_strains_loop(orig: Mesh, final: Mesh, fit_radius: float = 2.0,
                         only: np.ndarray | None = None):
    """Reference-shaped per-vertex loop.
    Kept as the validation oracle and as the fallback for vertices whose
    fit radius outgrows the vectorised candidate neighbourhood."""
    n = orig.nvertices
    idxs = np.arange(n) if only is None else np.asarray(only)
    out = np.zeros((4, len(idxs)))
    normals_o = orig.vertex_normals()
    coords_o = orig.coords
    coords_f = final.coords

    for j, idx in enumerate(idxs):
        kept: np.ndarray
        fit = fit_radius
        while True:
            d = np.linalg.norm(coords_o - coords_o[idx], axis=1)
            dir_ok = normals_o @ normals_o[idx] >= 0
            kept = np.nonzero((d <= fit) & dir_ok)[0]
            if len(kept) > 8:
                break
            fit += 0.5

        normal = normals_o[idx]
        e1, e2 = _tangs(normal)
        # flip normal outward as calculate_tangs does
        if np.dot(normal, coords_o[idx]) < 0:
            normal = -normal
            e1, e2 = _tangs(normal)

        rel_o = coords_o[kept] - coords_o[idx]
        t1 = rel_o @ e1
        t2 = rel_o @ e2
        nn = rel_o @ normal

        alpha = np.stack([np.zeros_like(t1), t1, t2, 0.5 * t1 * t1,
                          0.5 * t2 * t2, t1 * t2], axis=1)
        rel_f = coords_f[kept] - coords_f[idx]
        ft1 = rel_f @ e1
        ft2 = rel_f @ e2
        fn = rel_f @ normal

        pinv = np.linalg.pinv(alpha)
        a = pinv @ nn      # original surface height fit
        b = pinv @ ft1
        c = pinv @ ft2
        dd = pinv @ fn

        out[:, j] = _strain_from_fit(a, b, c, dd)
    return out, idxs


def _strain_from_fit(a, b, c, dd):
    """(max stretch, min stretch, Green strains) from the fitted
    coefficient vectors — shared by the loop and vectorised paths."""
    dNdT1, dNdT2 = a[1], a[2]
    g1_ref = np.array([1.0, 0.0, dNdT1])
    g2_ref = np.array([0.0, 1.0, dNdT2])
    g3_ref = np.cross(g1_ref, g2_ref)
    g3_ref /= np.linalg.norm(g3_ref)
    G = np.stack([g1_ref, g2_ref, g3_ref], axis=1)
    G_cont = np.linalg.inv(G).T

    g1 = np.array([b[1], c[1], dd[1]])
    g2 = np.array([b[2], c[2], dd[2]])
    g3 = np.cross(g1, g2)
    g3 /= np.linalg.norm(g3)
    g = np.stack([g1, g2, g3], axis=1)

    F = g @ G_cont.T
    Cg = F.T @ F
    w, U = np.linalg.eigh(Cg)
    mm = np.abs(g3_ref @ U)
    normal_dir = int(np.argmax(mm))
    sel = [i for i in range(3) if i != normal_dir]
    s = np.sqrt(np.maximum(w[sel], 0.0))
    smax, smin = max(s), min(s)
    return np.array([smax, smin, 0.5 * (smax * smax - 1),
                     0.5 * (smin * smin - 1)])


def _knn_candidates(coords: np.ndarray, normals: np.ndarray,
                    fit_radius: float):
    """Exact candidate neighbourhoods via k-NN (scipy cKDTree), k doubled
    until every vertex's grown fit radius is provably covered by its k-set:
    the k-set is complete for the ball of radius r whenever
    r <= distance-to-the-kth-neighbour. Returns (cand (N,C) int64 -1-padded
    self-excluded, chosen_r (N,)) reproducing the reference's 0.5-step
    radius growth (>8 admissible neighbours) in closed form."""
    from scipy.spatial import cKDTree
    n = coords.shape[0]
    tree = cKDTree(coords)
    k = min(max(32, 10), n)
    while True:
        dists, idx = tree.query(coords, k=k)
        # exclude self (always first at distance 0)
        d = dists[:, 1:]
        cand = idx[:, 1:]
        dir_ok = np.einsum("ncj,nj->nc", normals[cand], normals) >= 0
        d_adm = np.where(dir_ok, d, np.inf)
        d_sorted = np.sort(d_adm, axis=1)
        # the reference loop counts SELF toward its ">8 kept" bar, so the
        # radius only needs to capture the 8th-nearest OTHER vertex
        d9 = (d_sorted[:, 7] if d_sorted.shape[1] > 7
              else np.full(n, np.inf))
        steps = np.ceil(np.maximum(d9 - fit_radius, 0.0) / 0.5 - 1e-12)
        chosen_r = fit_radius + 0.5 * np.where(np.isfinite(steps), steps,
                                               0.0)
        covered = np.isfinite(d9) & (chosen_r <= dists[:, -1] + 1e-12)
        if covered.all() or k >= n:
            return cand, d, dir_ok, chosen_r, ~covered
        k = min(2 * k, n)


def vertex_strains(orig: Mesh, final: Mesh, fit_radius: float = 2.0):
    """Returns (4, N): max stretch, min stretch, and the corresponding
    Green strains 0.5*(s^2-1). Vectorised (see module docstring)."""
    n = orig.nvertices
    coords_o = np.asarray(orig.coords, np.float64)
    coords_f = np.asarray(final.coords, np.float64)
    normals_o = np.asarray(orig.vertex_normals(), np.float64)

    cand, d, dir_ok, chosen_r, fallback_mask = _knn_candidates(
        coords_o, normals_o, fit_radius)
    safe = cand
    rel_all = coords_o[safe] - coords_o[:, None, :]           # (N,C,3)

    kept = dir_ok & (d <= chosen_r[:, None])
    counts = kept.sum(1)
    # self always joins the loop's kept set (zero design row, no effect on
    # the fit), so >8-with-self means >=8 others here
    fallback = fallback_mask | (counts <= 7)

    # outward normal flip (calculate_tangs)
    flip = np.einsum("nj,nj->n", normals_o, coords_o) < 0
    normal = np.where(flip[:, None], -normals_o, normals_o)
    e1, e2 = _tangs_batch(normal)

    m = kept.astype(np.float64)                               # (N,C)
    t1 = np.einsum("ncj,nj->nc", rel_all, e1) * m
    t2 = np.einsum("ncj,nj->nc", rel_all, e2) * m
    nn = np.einsum("ncj,nj->nc", rel_all, normal) * m
    rel_f = (coords_f[safe] - coords_f[:, None, :])
    ft1 = np.einsum("ncj,nj->nc", rel_f, e1) * m
    ft2 = np.einsum("ncj,nj->nc", rel_f, e2) * m
    fn = np.einsum("ncj,nj->nc", rel_f, normal) * m

    # design matrix rows are zeroed for masked candidates => identical to
    # excluding them from the least-squares fit
    A = np.stack([np.zeros_like(t1), t1, t2, 0.5 * t1 * t1,
                  0.5 * t2 * t2, t1 * t2], axis=2)            # (N,C,6)
    pinv = np.linalg.pinv(A)                                  # (N,6,C)
    coef = np.einsum("nkc,ncr->nkr", pinv,
                     np.stack([nn, ft1, ft2, fn], axis=2))    # (N,6,4)
    a, b, c_, dd = coef[..., 0], coef[..., 1], coef[..., 2], coef[..., 3]

    g1_ref = np.stack([np.ones(n), np.zeros(n), a[:, 1]], 1)
    g2_ref = np.stack([np.zeros(n), np.ones(n), a[:, 2]], 1)
    g3_ref = np.cross(g1_ref, g2_ref)
    g3_ref /= np.linalg.norm(g3_ref, axis=1, keepdims=True)
    G = np.stack([g1_ref, g2_ref, g3_ref], axis=2)            # (N,3,3)
    G_cont = np.swapaxes(np.linalg.inv(G), 1, 2)

    g1 = np.stack([b[:, 1], c_[:, 1], dd[:, 1]], 1)
    g2 = np.stack([b[:, 2], c_[:, 2], dd[:, 2]], 1)
    g3 = np.cross(g1, g2)
    g3n = np.linalg.norm(g3, axis=1, keepdims=True)
    g3 = g3 / np.where(g3n > 0, g3n, 1.0)
    g = np.stack([g1, g2, g3], axis=2)

    F = np.einsum("nij,nkj->nik", g, G_cont)
    Cg = np.einsum("nji,njk->nik", F, F)
    w, U = np.linalg.eigh(Cg)                                 # ascending
    mm = np.abs(np.einsum("nj,njk->nk", g3_ref, U))
    normal_dir = np.argmax(mm, axis=1)
    sel = np.stack([np.where(normal_dir == 0, 1, 0),
                    np.where(normal_dir == 2, 1, 2)], axis=1)  # the other 2
    s = np.sqrt(np.maximum(np.take_along_axis(w, sel, axis=1), 0.0))
    smax = s.max(1)
    smin = s.min(1)
    out = np.stack([smax, smin, 0.5 * (smax * smax - 1),
                    0.5 * (smin * smin - 1)])

    if fallback.any():
        vals, idxs = _vertex_strains_loop(orig, final, fit_radius,
                                          only=np.nonzero(fallback)[0])
        out[:, idxs] = vals
    return out


def vertex_strains_mesh(orig: Mesh, final: Mesh, fit_radius: float = 2.0) -> Mesh:
    data = vertex_strains(orig, final, fit_radius)
    return Mesh(coords=final.coords.copy(), faces=final.faces, data=data)
