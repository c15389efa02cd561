"""Frozen copy of the port's synthetic cohort generator (eval/synth.py's
`synth_cohort` and its helpers, with the icosphere construction of
core/icosphere.py), so that neither a later change to the program nor the
program itself decides what the benchmark feeds it or what the reference
takes as the truth.

Numpy only. A subject is addressed by its id alone: with the group
pattern's seed fixed at 0 (the template every cell registers to), subject
`sid` is exactly `synth_cohort(res, n, seed=0)`'s subject number `sid`
(warp seed `sid`, idiosyncratic stream `(0, sid, 5)`). A traffic mix names
a fixed pool of subjects; the benchmark's `--seed` only orders them
(`arrange`), so every seed gives the window the same work.
"""
from __future__ import annotations

import functools

import numpy as np

RAD = 100.0
PATTERN_SEED = 0


def _base_icosahedron():
    """12-vertex icosahedron in the reference's vertex and face order."""
    tau = 0.8506508084
    one = 0.5257311121
    pts = np.array([
        [tau, one, 0.0], [-tau, one, 0.0], [-tau, -one, 0.0],
        [tau, -one, 0.0], [one, 0.0, tau], [one, 0.0, -tau],
        [-one, 0.0, -tau], [-one, 0.0, tau], [0.0, tau, one],
        [0.0, -tau, one], [0.0, -tau, -one], [0.0, tau, -one]],
        dtype=np.float64)
    ZA, ZB, ZC, ZD, YA, YB, YC, YD, XA, XB, XC, XD = range(12)
    faces = np.array([
        [YD, XA, YA], [XB, YD, YA], [XD, YC, YB], [YC, XC, YB],
        [ZD, YA, ZA], [YB, ZD, ZA], [ZB, YD, ZC], [YC, ZB, ZC],
        [XD, ZA, XA], [ZB, XD, XA], [ZD, XC, XB], [XC, ZC, XB],
        [ZA, YA, XA], [YB, ZA, XD], [ZD, XB, YA], [XC, ZD, YB],
        [ZB, XA, YD], [XD, ZB, YC], [XB, ZC, YD], [ZC, XC, YC]],
        dtype=np.int32)
    return pts, faces[:, [0, 2, 1]]


def _retessellate(coords, faces):
    """One 4-to-1 subdivision; a new midpoint is numbered by the first use
    of its edge in the face sequence (p0 = mid(v1,v2), p1 = mid(v0,v2),
    p2 = mid(v0,v1) per face)."""
    n, nf = coords.shape[0], faces.shape[0]
    v0, v1, v2 = (faces[:, i].astype(np.int64) for i in range(3))
    ea = np.stack([v1, v0, v0], axis=1).reshape(-1)
    eb = np.stack([v2, v2, v1], axis=1).reshape(-1)
    key = np.minimum(ea, eb) * n + np.maximum(ea, eb)
    _, first, inverse = np.unique(key, return_index=True, return_inverse=True)
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    mid = (n + rank[inverse.reshape(-1)]).reshape(nf, 3)
    p0, p1, p2 = mid[:, 0], mid[:, 1], mid[:, 2]
    new_faces = np.stack([
        np.stack([p2, p0, p1], axis=1), np.stack([p1, v0, p2], axis=1),
        np.stack([p0, v2, p1], axis=1), np.stack([p2, v1, p0], axis=1),
    ], axis=1).reshape(nf * 4, 3).astype(np.int32)
    made = first[order]
    out = np.vstack([coords, 0.5 * (coords[ea[made]] + coords[eb[made]])])
    return out / np.linalg.norm(out, axis=1, keepdims=True), new_faces


@functools.lru_cache(maxsize=None)
def _icosphere(res: int):
    coords, faces = _base_icosahedron()
    coords = coords / np.linalg.norm(coords, axis=1, keepdims=True)
    for _ in range(res):
        coords, faces = _retessellate(coords, faces)
    coords.setflags(write=False)
    faces.setflags(write=False)
    return coords, faces


def icosphere(res: int):
    """(coords (N,3) at radius RAD, faces (T,3) int32) of the level-`res`
    icosphere, as the program's Mesh.from_icosphere + true_rescale give."""
    unit, faces = _icosphere(res)
    coords = unit * RAD
    coords = coords / np.linalg.norm(coords, axis=1, keepdims=True) * RAD
    return coords, faces.copy()


def _wave_field(unit, rng, n_terms, kmin, kmax):
    """Sum of random plane-wave sinusoids with |k| in [kmin,kmax] cycles a
    half-turn, unit variance."""
    out = np.zeros(unit.shape[0])
    for _ in range(n_terms):
        k = rng.normal(size=3)
        k *= rng.uniform(kmin, kmax) / np.linalg.norm(k)
        phase = rng.uniform(0, 2 * np.pi)
        out += rng.normal() * np.sin(unit @ k * np.pi + phase)
    s = out.std()
    return out / (s if s > 0 else 1.0)


def group_pattern(unit, seed: int = PATTERN_SEED, n_terms: int = 24):
    """The analytic group-mean (sulc, curv) pattern at unit directions."""
    rng_s = np.random.default_rng((seed, 1))
    rng_c = np.random.default_rng((seed, 2))
    sulc = _wave_field(unit, rng_s, n_terms, 1.5, 4.0)
    hf = _wave_field(unit, rng_c, n_terms, 6.0, 12.0)
    curv = 0.55 * hf + 0.45 * _wave_field(unit, np.random.default_rng(
        (seed, 3)), n_terms, 4.0, 8.0) * np.sign(sulc)
    return np.stack([sulc, curv / max(curv.std(), 1e-9)])


def true_warp(unit, sid: int, amplitude_deg: float = 9.0):
    """Subject `sid`'s smooth warp of the unit sphere: where the template's
    pattern is read for each of its vertices (unit directions)."""
    rng = np.random.default_rng((PATTERN_SEED * 1000 + sid, 77))
    disp = np.stack([_wave_field(unit, rng, 8, 0.8, 2.0) for _ in range(3)],
                    axis=1)
    disp -= unit * np.sum(disp * unit, axis=1, keepdims=True)
    rms = np.sqrt((disp ** 2).sum(axis=1).mean())
    disp *= np.radians(amplitude_deg) / max(rms, 1e-9)
    warped = unit + disp
    return warped / np.linalg.norm(warped, axis=1, keepdims=True)


def template_data(res: int):
    """(2,N) template (sulc, curv) on the level-`res` icosphere."""
    return group_pattern(icosphere(res)[0] / RAD)


def subject_data(res: int, sid: int, noise: float = 0.45):
    """(2,N) data of subject `sid` on the level-`res` icosphere: the group
    pattern at the subject's warp plus smooth idiosyncratic folds, each
    channel scaled to unit variance."""
    unit = icosphere(res)[0] / RAD
    data = group_pattern(true_warp(unit, sid))
    rng = np.random.default_rng((PATTERN_SEED, sid, 5))
    for d in range(2):
        kmin, kmax = (2.0, 5.0) if d == 0 else (6.0, 12.0)
        data[d] = data[d] + noise * _wave_field(unit, rng, 12, kmin, kmax)
        data[d] /= data[d].std()
    return data


def draw_subjects(seed: int, n: int, pool: int = 1_000_000) -> list:
    """`n` distinct subject ids drawn from `seed` (any whole number)."""
    rng = np.random.default_rng(int(seed))
    return [int(s) for s in rng.choice(pool, size=n, replace=False)]


def arrange(pool_seed: int, seed: int, per_unit: int, warm_units: int,
            units: int):
    """The subjects of a run: a fixed pool drawn from `pool_seed`, cut into
    warm-up units and window units of `per_unit` subjects; `seed` (any
    whole number) permutes the window units. The subjects inside a unit
    keep the pool's order: a cohort's result depends on the order of its
    subjects, and the limits of `correct` hold each subject to what it
    reads in its unit. Returns (warm-up units, window units), lists of id
    lists."""
    ids = draw_subjects(pool_seed, per_unit * (warm_units + units))
    cut = [ids[k * per_unit:(k + 1) * per_unit]
           for k in range(warm_units + units)]
    rng = np.random.default_rng(int(seed))
    window = [cut[warm_units + k] for k in rng.permutation(units)]
    return cut[:warm_units], window
