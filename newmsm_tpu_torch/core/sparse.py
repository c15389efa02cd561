"""Sparse connectivity data: load, prep, and reduce WITHOUT densifying.

The reference advertises a sparse path for high-dimensional connectivity
matrices (`--issparse`, SpMat loader at reg_tools.cpp:846-855) but the path
is vestigial as shipped: `featurespace::initialise` unconditionally
overwrites the loaded SparseBFMatrix with a FullBFMatrix of the *mesh's*
resampled pvalues (featurespace.cpp:67-72), and the sparse branch of
set_data never loads any data onto the mesh — so a sparse discrete
registration in the reference operates on empty data. This module provides
the working equivalent of what that path was for (connectivity-MSM):

  * ``load_sparse`` — spconvert triplet file -> scipy CSR, never dense;
  * ``resample_columns`` / ``smooth_columns`` — featurespace prep (adaptive
    barycentric resample, geodesic Gaussian smoothing) applied to an
    (R, N) connectivity matrix column-wise as sparse @ sparse products;
  * ``seed_features`` / ``window`` — the standard connectivity-MSM feature
    reduction: a small set of seed rows (or an explicit row window)
    densifies into the (F, N) feature matrix the registration drivers
    consume — O(F*N), never O(R*N);
  * ``pearson_columns`` — exact full-dimension Pearson between connectivity
    columns from sparse statistics (for similarity QC at native dimension).

All host-side (scipy) by design: this is data preparation, not the device
hot path. Only ``resample_columns`` computes on a device (the adaptive
weights of ops.resample); it takes `device`, None meaning cuda.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def load_sparse(filename: str) -> sp.csr_matrix:
    """spconvert triplet text (`row col value`, 1-based, trailing
    `nrows ncols 0` dimension row; duplicate triplets sum — matching
    io.read_spmat / MISCMATHS::SpMat) -> scipy CSR, never densified."""
    trip = np.loadtxt(filename, comments="%", ndmin=2)
    if trip.shape[1] != 3:
        raise ValueError(f"{filename}: expected 3-column sparse triplets")
    r, c, v = trip[:, 0].astype(int), trip[:, 1].astype(int), trip[:, 2]
    nr, nc = int(r.max()), int(c.max())
    if v[-1] == 0.0 and r[-1] == nr and c[-1] == nc:
        r, c, v = r[:-1], c[:-1], v[:-1]
    return sp.coo_matrix((v, (r - 1, c - 1)), shape=(nr, nc)).tocsr()


def _weights_matrix(idx: np.ndarray, w: np.ndarray, n_src: int) -> sp.csr_matrix:
    """(Q,cap) padded index/weight rows -> (Q, n_src) CSR row-stochastic
    interpolation matrix (padding rows carry w == 0 / idx == -1)."""
    q, cap = idx.shape
    rows = np.repeat(np.arange(q), cap)
    cols = idx.reshape(-1)
    vals = w.reshape(-1)
    keep = (cols >= 0) & (vals != 0)
    return sp.coo_matrix((vals[keep], (rows[keep], cols[keep])),
                         shape=(q, n_src)).tocsr()


def resample_columns(C: sp.spmatrix, src_mesh, dst_mesh,
                     device=None) -> sp.csr_matrix:
    """Adaptive-barycentric resample of connectivity columns onto a new
    grid: C (R, N_src) -> (R, N_dst), computed as C @ W^T with the SAME
    weights metric_resample uses (resampler.cpp:72-140) — the sparse
    analogue of featurespace's per-level resampling."""
    from .. import resolve_device
    from ..ops.resample import _adaptive_cap, _f32, _tables, adaptive_weights

    device = resolve_device(device)
    idx, w = adaptive_weights(
        _f32(src_mesh.coords, device), _f32(dst_mesh.coords, device),
        _tables(src_mesh, device), _tables(dst_mesh, device),
        _f32(src_mesh.vertex_area(), device),
        _f32(dst_mesh.vertex_area(), device),
        None, cap=_adaptive_cap(src_mesh.nvertices, dst_mesh.nvertices))
    W = _weights_matrix(idx.cpu().numpy(), w.cpu().numpy().astype(np.float64),
                        src_mesh.nvertices)
    return (C.tocsr() @ W.T).tocsr()


def smooth_columns(C: sp.spmatrix, mesh, sigma: float) -> sp.csr_matrix:
    """Geodesic Gaussian smoothing of each connectivity column
    (smooth_data, resampler.cpp:169-230: neighbours within angular radius
    4*asin(sigma/2R), Gaussian-weighted, row-normalised), as one sparse
    product."""
    coords = np.asarray(mesh.coords)
    n = coords.shape[0]
    rad = float(np.linalg.norm(coords[0]))
    ang = 4.0 * np.arcsin(min(1.0, sigma / (2.0 * rad)))
    # neighbour search via cKDTree on chord distance
    from scipy.spatial import cKDTree
    chord = 2.0 * rad * np.sin(ang / 2.0)
    tree = cKDTree(coords)
    pairs = tree.query_pairs(chord, output_type="ndarray")
    ii = np.concatenate([pairs[:, 0], pairs[:, 1], np.arange(n)])
    jj = np.concatenate([pairs[:, 1], pairs[:, 0], np.arange(n)])
    d = np.linalg.norm(coords[ii] - coords[jj], axis=1)
    geo = 2.0 * rad * np.arcsin(np.clip(d / (2 * rad), -1, 1))
    g = np.exp(-0.5 * (geo / sigma) ** 2)
    G = sp.coo_matrix((g, (ii, jj)), shape=(n, n)).tocsr()
    norm = np.asarray(G.sum(axis=1)).ravel()
    Dinv = sp.diags(1.0 / np.maximum(norm, 1e-30))
    return (C.tocsr() @ (Dinv @ G).T).tocsr()


def window(C: sp.spmatrix, rows: np.ndarray) -> np.ndarray:
    """Densify an explicit row window: (len(rows), N) — the per-patch
    escape hatch; never materialises more than the requested rows."""
    return np.asarray(C.tocsr()[np.asarray(rows)].todense())


def seed_features(C: sp.spmatrix, seeds: np.ndarray,
                  standardise: bool = True) -> np.ndarray:
    """Connectivity-MSM feature reduction: the (F, N) dense feature matrix
    of connection strength to F seed rows — the standard way a
    (R x N) connectome drives surface registration without ever holding
    the dense matrix. Optionally per-feature standardised."""
    out = window(C, seeds).astype(np.float64)
    if standardise:
        mu = out.mean(axis=1, keepdims=True)
        sd = out.std(axis=1, keepdims=True)
        out = (out - mu) / np.maximum(sd, 1e-12)
    return out


def pearson_columns(C_a: sp.spmatrix, C_b: sp.spmatrix,
                    ia: np.ndarray, ib: np.ndarray) -> np.ndarray:
    """Exact Pearson correlation over the FULL row dimension between
    columns C_a[:, ia[k]] and C_b[:, ib[k]], from sparse statistics only
    (the rigid path's column similarity, similarities.cpp:129-158, at
    native connectivity dimension)."""
    A = C_a.tocsc()
    B = C_b.tocsc()
    R = A.shape[0]
    ia = np.asarray(ia)
    ib = np.asarray(ib)
    out = np.empty(len(ia))
    for k, (i, j) in enumerate(zip(ia, ib)):
        a = A.getcol(int(i))
        b = B.getcol(int(j))
        sa, sb = a.sum(), b.sum()
        saa = (a.multiply(a)).sum()
        sbb = (b.multiply(b)).sum()
        sab = (a.multiply(b)).sum()
        ma, mb = sa / R, sb / R
        cov = sab / R - ma * mb
        va = saa / R - ma * ma
        vb = sbb / R - mb * mb
        denom = np.sqrt(max(va, 0.0)) * np.sqrt(max(vb, 0.0))
        out[k] = cov / denom if denom > 0 else 0.0
    return out
