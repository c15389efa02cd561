"""Synthetic cortical-map cohorts with HCP-like statistics.

The reference validates registration quality on HCP sulc/curv data
(docs/guide.md:429-440); that data cannot ship with this repo, so the smoke
run and the tests generate cohorts whose statistics mimic it (the port's
own copy of the JAX package's eval/synth.py):

  * ``sulc``-like channel: band-limited smooth field (angular wavelengths
    ~45-120 deg — primary folding pattern scale),
  * ``curv``-like channel: higher-frequency field (~15-35 deg) mixed with
    the sulc gradient direction, so the two channels are correlated the way
    curvature ridges follow sulcal banks,
  * per-subject anatomy: the group pattern composed with a smooth random
    spherical warp (the residual misalignment left after affine alignment,
    a few degrees of arc) plus smooth idiosyncratic "noise" folds, which
    bound the achievable group CC below 1 exactly like real subjects do.

Defaults (warp 9 deg RMS, noise 0.45) are calibrated so the UNREGISTERED
cohort CC lands at HCP-like levels (sulc ~0.50, curv ~0.07 — round-3's
0.70/0.17 start was far above real cohorts and flattened the measured
improvement; the reference's post-registration typical row is CC sulc
0.722 / curv 0.2469, docs/guide.md:431-436).

All fields are analytic (sums of plane-wave sinusoids evaluated at unit
coordinates), so subject data can be sampled exactly at warped positions —
no resampling error enters the ground truth.
"""
from __future__ import annotations

import numpy as np

from .. import RAD
from ..core.mesh import Mesh


def _wave_field(unit: np.ndarray, rng: np.random.Generator, n_terms: int,
                kmin: float, kmax: float) -> np.ndarray:
    """Sum of random plane-wave sinusoids with |k| in [kmin,kmax] (angular
    frequency in cycles per half-turn), unit-variance."""
    out = np.zeros(unit.shape[0])
    for _ in range(n_terms):
        k = rng.normal(size=3)
        k *= rng.uniform(kmin, kmax) / np.linalg.norm(k)
        phase = rng.uniform(0, 2 * np.pi)
        out += rng.normal() * np.sin(unit @ k * np.pi + phase)
    s = out.std()
    return out / (s if s > 0 else 1.0)


class GroupPattern:
    """Analytic group-mean cortical pattern: evaluate (sulc, curv) at any
    set of unit directions."""

    def __init__(self, seed: int = 0, n_terms: int = 24):
        self._seed = seed
        self._n = n_terms

    def __call__(self, unit: np.ndarray) -> np.ndarray:
        rng_s = np.random.default_rng((self._seed, 1))
        rng_c = np.random.default_rng((self._seed, 2))
        sulc = _wave_field(unit, rng_s, self._n, 1.5, 4.0)
        hf = _wave_field(unit, rng_c, self._n, 6.0, 12.0)
        # curvature partially tracks the sulcal pattern's fine structure
        curv = 0.55 * hf + 0.45 * _wave_field(unit, np.random.default_rng(
            (self._seed, 3)), self._n, 4.0, 8.0) * np.sign(sulc)
        return np.stack([sulc, curv / max(curv.std(), 1e-9)])


def smooth_sphere_warp(unit: np.ndarray, seed: int,
                       amplitude_deg: float = 6.0) -> np.ndarray:
    """Smooth random warp of the unit sphere: a low-frequency tangential
    displacement field, renormalised. Amplitude is the RMS arc displacement
    in degrees (HCP post-affine residual misalignment scale)."""
    rng = np.random.default_rng((seed, 77))
    disp = np.stack([_wave_field(unit, rng, 8, 0.8, 2.0) for _ in range(3)],
                    axis=1)
    # project to the tangent plane so the warp is (approximately) a rotation
    # field rather than radial noise
    disp -= unit * np.sum(disp * unit, axis=1, keepdims=True)
    rms = np.sqrt((disp ** 2).sum(axis=1).mean())
    disp *= np.radians(amplitude_deg) / max(rms, 1e-9)
    warped = unit + disp
    return warped / np.linalg.norm(warped, axis=1, keepdims=True)


def synth_cohort(res: int, n_subjects: int, seed: int = 0,
                 warp_deg: float = 9.0, noise: float = 0.45,
                 idio_band: str = "smooth"):
    """Build a cohort of n_subjects (mesh, (2,N) data) on the ico-`res`
    sphere plus the (2,N) group-template data.

    Subject s's data = group_pattern(warp_s(x)) + noise * idiosyncratic(x):
    registration should recover (approximately) warp_s^{-1}. Returns
    (meshes, datasets, template_data).

    idio_band: "smooth" (default, rounds 3-4) puts the idiosyncratic folds
    at the same angular scales as the group pattern — they are then
    mutually ALIGNABLE by warping, so a groupwise objective is rewarded
    (in CC) for deformation real cortical anatomy would not repay (the
    distortion-overshoot confound diagnosed in PARITY_RESULTS.md round 4).
    "hf" moves the idiosyncratic energy to 12-25 cycles/half-turn — well
    below the control-grid resolution, non-alignable, like real
    subject-specific microstructure — removing that confound."""
    sphere = Mesh.from_icosphere(res)
    sphere.true_rescale(RAD)
    unit = np.asarray(sphere.coords) / RAD
    pattern = GroupPattern(seed)

    template_data = pattern(unit)

    meshes, datasets = [], []
    for s in range(n_subjects):
        w = smooth_sphere_warp(unit, seed=seed * 1000 + s, amplitude_deg=warp_deg)
        data = pattern(w)
        rng = np.random.default_rng((seed, s, 5))
        for d in range(2):
            if idio_band == "hf":
                kmin, kmax = (12.0, 20.0) if d == 0 else (16.0, 25.0)
            else:
                kmin, kmax = (2.0, 5.0) if d == 0 else (6.0, 12.0)
            idio = _wave_field(unit, rng, 12, kmin, kmax)
            data[d] = data[d] + noise * idio
            data[d] /= data[d].std()
        meshes.append(Mesh(coords=sphere.coords.copy(), faces=sphere.faces))
        datasets.append(data)
    return meshes, datasets, template_data


def multimodal_cohort(res: int, n_subjects: int, n_channels: int = 10,
                      seed: int = 0, warp_deg: float = 9.0,
                      noise: float = 0.45):
    """Cohort with D>=3 channels mimicking the HCP MSMAll feature set
    (myelin + RSN maps + sulc/curv; the reference's
    config/HCP_multimodal_alignment recipe): channel 0/1 are the sulc/curv
    pair from ``GroupPattern``; channel 2 is myelin-like (very low frequency,
    correlated with sulc the way myelin tracks areal boundaries); channels
    3+ are RSN-connectivity-like mid-frequency maps, mutually decorrelated.
    All channels ride the SAME per-subject warp, so a multivariate
    registration can pool evidence across them exactly as MSMAll does.
    Returns (meshes, datasets (D,N), template_data (D,N))."""
    sphere = Mesh.from_icosphere(res)
    sphere.true_rescale(RAD)
    unit = np.asarray(sphere.coords) / RAD
    pattern = GroupPattern(seed)

    def channels(u):
        base = pattern(u)                              # (2,N) sulc/curv
        out = [base[0], base[1]]
        rng_m = np.random.default_rng((seed, 101))
        myelin = (0.5 * _wave_field(u, rng_m, 16, 0.8, 2.0)
                  + 0.5 * np.tanh(base[0]))
        out.append(myelin / max(myelin.std(), 1e-9))
        for c in range(3, n_channels):
            rng_c = np.random.default_rng((seed, 200 + c))
            out.append(_wave_field(u, rng_c, 20, 2.0 + 0.5 * (c % 4),
                                   5.0 + 0.7 * (c % 5)))
        return np.stack(out)

    template_data = channels(unit)
    meshes, datasets = [], []
    for s in range(n_subjects):
        w = smooth_sphere_warp(unit, seed=seed * 1000 + s,
                               amplitude_deg=warp_deg)
        data = channels(w)
        rng = np.random.default_rng((seed, s, 9))
        for d in range(data.shape[0]):
            idio = _wave_field(unit, rng, 12, 2.0, 8.0)
            data[d] = data[d] + noise * idio
            data[d] /= data[d].std()
        meshes.append(Mesh(coords=sphere.coords.copy(), faces=sphere.faces))
        datasets.append(data)
    return meshes, datasets, template_data


def longitudinal_pair(res: int, seed: int = 0, warp_deg: float = 8.0,
                      growth: float = 1.15, fold_amp: float = 0.10):
    """Synthetic longitudinal aMSM case (NeuroImage2017
    aMSM_STR_longitudinal_alignment: same subject at two timepoints, the
    later with grown, deeper-folded anatomy). Returns
    (in_mesh, in_data, in_anat, ref_mesh, ref_data, ref_anat):

      * spheres: identical ico-``res`` spheres (radius 100),
      * data: one sulc-like channel; timepoint-2 features sit at
        w(x) so registration should recover w,
      * anatomy: folded surfaces r(x) = R*(1 + fold_amp*fold(x)); the
        timepoint-2 anatomy carries the SAME folds at the warped positions,
        ``growth``-scaled and slightly deepened — so the spherical warp that
        aligns the data also aligns the anatomies (the aMSM premise).
    """
    sphere = Mesh.from_icosphere(res)
    sphere.true_rescale(RAD)
    unit = np.asarray(sphere.coords) / RAD
    pattern = GroupPattern(seed)

    w = smooth_sphere_warp(unit, seed=seed * 77 + 3, amplitude_deg=warp_deg)

    def sulc(u):
        return pattern(u)[0]

    in_data = sulc(unit)[None, :]
    ref_data = sulc(w)[None, :]
    in_data = in_data / in_data.std()
    ref_data = ref_data / ref_data.std()

    def folded(u, amp, scale):
        r = RAD * scale * (1.0 + amp * sulc(u))
        return u * r[:, None]

    in_anat = Mesh(coords=folded(unit, fold_amp, 1.0), faces=sphere.faces)
    ref_anat = Mesh(coords=folded(w, fold_amp * 1.2, growth),
                    faces=sphere.faces)
    in_mesh = Mesh(coords=sphere.coords.copy(), faces=sphere.faces)
    ref_mesh = Mesh(coords=sphere.coords.copy(), faces=sphere.faces)
    return in_mesh, in_data, in_anat, ref_mesh, ref_data, ref_anat
