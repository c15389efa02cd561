"""Frozen copy of the port's multimodal cohort generator (eval/synth.py's
`multimodal_cohort`), addressed by subject id, so that neither a later
change to the program nor the program itself decides what the benchmark's
multimodal cells feed it or what the reference takes as the truth.

Numpy only; the icosphere, the wave fields, the (sulc, curv) group pattern
and the warp are those of the frozen pairwise generator (synth.py). With
the pattern seed fixed at 0, subject `sid` is exactly
`multimodal_cohort(res, n, n_channels, seed=0)`'s subject number `sid`: the
warp of seed `sid` (synth.true_warp, 9 degrees RMS) and the idiosyncratic
stream `(0, sid, 9)`. The channels, as the HCP's MSMAll feature set has
them: 0/1 sulc and curv, 2 a myelin-like map (very low frequency, tracking
sulc), 3 and up resting-state-network-like mid-frequency maps.
"""
from __future__ import annotations

import numpy as np

from .synth import (PATTERN_SEED, RAD, _wave_field, arrange, group_pattern,
                    icosphere, true_warp)

__all__ = ["channels", "template_data", "subject_data", "true_warp",
           "icosphere", "arrange", "RAD"]


def channels(unit, n_channels: int):
    """The (n_channels, N) multimodal pattern at unit directions."""
    base = group_pattern(unit)
    out = [base[0], base[1]]
    rng_m = np.random.default_rng((PATTERN_SEED, 101))
    myelin = (0.5 * _wave_field(unit, rng_m, 16, 0.8, 2.0)
              + 0.5 * np.tanh(base[0]))
    out.append(myelin / max(myelin.std(), 1e-9))
    for c in range(3, n_channels):
        rng_c = np.random.default_rng((PATTERN_SEED, 200 + c))
        out.append(_wave_field(unit, rng_c, 20, 2.0 + 0.5 * (c % 4),
                               5.0 + 0.7 * (c % 5)))
    return np.stack(out)


def template_data(res: int, n_channels: int):
    """(D,N) template on the level-`res` icosphere."""
    return channels(icosphere(res)[0] / RAD, n_channels)


def subject_data(res: int, sid: int, n_channels: int, noise: float = 0.45):
    """(D,N) data of subject `sid`: the pattern at the subject's warp plus
    smooth idiosyncratic folds, each channel scaled to unit variance."""
    unit = icosphere(res)[0] / RAD
    data = channels(true_warp(unit, sid), n_channels)
    rng = np.random.default_rng((PATTERN_SEED, sid, 9))
    for d in range(data.shape[0]):
        data[d] = data[d] + noise * _wave_field(unit, rng, 12, 2.0, 8.0)
        data[d] /= data[d].std()
    return data

