"""Intensity normalisation: histogram matching and variance normalisation.

A numpy copy of newmsm_tpu/ops/histogram.py (multivariate_histogram_
normalization and variance_normalise, reg_tools.cpp:745-844). It is host
code and holds no JAX, but it cannot be imported from the JAX package:
importing anything under newmsm_tpu.ops loads JAX (newmsm_tpu/ops/
__init__.py imports ops.nearest), and the port must run where JAX is not
installed.
"""
from __future__ import annotations

import numpy as np

NUMBINS = 256


def _hist_cdf(values: np.ndarray, include: np.ndarray):
    v = values[include]
    if v.size == 0:
        return None
    lo, hi = v.min(), v.max()
    if hi <= lo:
        hi = lo + 1e-12
    edges = np.linspace(lo, hi, NUMBINS + 1)
    hist, _ = np.histogram(v, bins=edges)
    cdf = np.cumsum(hist).astype(np.float64)
    cdf /= cdf[-1]
    return edges, cdf


def histogram_match_row(src: np.ndarray, ref: np.ndarray,
                        incl_src: np.ndarray, incl_ref: np.ndarray) -> np.ndarray:
    """Map src values so their (included) histogram matches ref's."""
    hs = _hist_cdf(src, incl_src)
    hr = _hist_cdf(ref, incl_ref)
    if hs is None or hr is None:
        return src.copy()
    edges_s, cdf_s = hs
    edges_r, cdf_r = hr
    centers_s = 0.5 * (edges_s[:-1] + edges_s[1:])
    centers_r = 0.5 * (edges_r[:-1] + edges_r[1:])
    u = np.interp(src, centers_s, cdf_s, left=0.0, right=1.0)
    return np.interp(u, cdf_r, centers_r, left=centers_r[0], right=centers_r[-1])


def _included(excl, k: int, n: int) -> np.ndarray:
    if excl is None:
        return np.ones(n, bool)
    rows = np.atleast_2d(excl)
    return rows[min(k, rows.shape[0] - 1)] != 0


def multivariate_histogram_normalization(data_in: np.ndarray, data_ref: np.ndarray,
                                         excl_in: np.ndarray | None = None,
                                         excl_ref: np.ndarray | None = None) -> np.ndarray:
    """Per-row histogram matching of data_in (D,N) onto data_ref (D,M)
    (reg_tools.cpp:745-802). Exclusion masks: nonzero == included."""
    out = data_in.copy()
    for k in range(data_in.shape[0]):
        out[k] = histogram_match_row(
            data_in[k], data_ref[k], _included(excl_in, k, data_in.shape[1]),
            _included(excl_ref, k, data_ref.shape[1]))
    return out


def variance_normalise(data: np.ndarray, excl: np.ndarray | None = None) -> np.ndarray:
    """Per-row standardisation over included entries; excluded entries keep
    their values (reg_tools.cpp:804-844). data (D,N) -> new (D,N)."""
    out = data.copy()
    incl = np.ones(data.shape[1], bool) if excl is None else (excl != 0)
    for k in range(data.shape[0]):
        v = data[k][incl]
        if v.size < 2:
            continue
        var = v.var(ddof=1)
        nv = v - v.mean()
        if var > 0:
            nv = nv / np.sqrt(var)
        out[k][incl] = nv
    return out
