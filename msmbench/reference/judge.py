"""The numbers that decide `correct`: what the timed units produced, worked
out again from the same inputs by the plain reference (geometry.py) and
compared value by value.

Each judge takes plain arrays (what the harness generated and what the
program wrote or returned) and returns {name: value}; `checks()` holds
each value against its limit. The reference reads the program's output
spheres only to judge them: it recomputes from them, and from the inputs,
everything the program derived after its optimiser (the resampled data,
the distortion, the correlations, the dedrift). The optimiser's own
result, which it cannot recompute, it scores in float64 subject by subject
from the output sphere: the CC of the subject's data carried through it
to the template, and the mean angle from where each vertex went to where
the generator's known warp took it, over the same before registration.
Each subject's score is held to what that subject reads in sound runs
(the cell's `bands`, a limits file's "subjects"): `cc_drop` and
`warp_rise` are the mean shortfalls over the run's subjects.

`control_*` compute the same outputs as the program's stand-in at the
precision just below the program's (see PERF.md): the resampled maps from
TF32-rounded inputs in float32 (the program resamples in float32 with
TF32 off), the distortion and correlation statistics in float32 (the
program computes them in float64 on the host).

Imports torch, numpy and the benchmark's frozen generator only.
"""
from __future__ import annotations

import numpy as np
import torch

from . import geometry as G
from .. import synth

# an entry of a resampled map is "off" when it is further than this from
# the reference's (the maps are unit-variance data; float32 rounding puts
# the program within ~1e-5, a face tie flips a whole row)
OFF_TOL = 1e-4
# a dedrifted vertex is "off" when it is further than this (mm, on the
# radius-100 sphere) from the reference's dedrift: float32 puts the
# program within ~5e-4 mm; where the projection folds, the program's
# unfold (which the reference does not redo) moves a few vertices further
DEDRIFT_TOL_MM = 0.01
STAT_KEYS = ("areal_mean", "areal_max", "areal_95", "areal_98",
             "shape_mean", "shape_max")


def _faces(faces, device):
    return torch.as_tensor(np.asarray(faces, np.int64), device=device)


def _stat_gap(got: dict, want: dict) -> float:
    """Largest relative gap over the distortion statistics."""
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-3)
               for k in STAT_KEYS)


def warp_ratio(orig, reg, sid: int) -> float:
    """The mean angle from each registered vertex to where the generator's
    warp of subject `sid` took it, over the same from the vertex before
    registration (float64)."""
    unit = orig / torch.linalg.norm(orig, dim=1, keepdim=True)
    truth = torch.as_tensor(synth.true_warp(unit.cpu().numpy(), sid),
                            device=orig.device)
    return float(G.angle_deg(reg, truth).mean()
                 / G.angle_deg(orig, truth).mean())


def band_numbers(scores: dict, bands: dict) -> dict:
    """scores: {sid: {"cc", "warp_ratio"}} of a run's subjects; bands: the
    same of sound runs, keyed by str(sid). Returns, over the subjects that
    have a band, the mean CC shortfall and the mean warp-ratio excess (a
    subject that reads better counts negative: a change of rounding moves
    single subjects either way, a broken optimiser moves them all one
    way), and the count of subjects that have no band."""
    drops, rises, unbanded = [], [], 0
    for sid, got in scores.items():
        want = bands.get(str(sid))
        if want is None:
            unbanded += 1
            continue
        drops.append(want["cc"] - got["cc"])
        rises.append(got["warp_ratio"] - want["warp_ratio"])
    return {"cc_drop": float(np.mean(drops)) if drops else 0.0,
            "warp_rise": float(np.mean(rises)) if rises else 0.0,
            "unbanded": unbanded}


def _off(got, want) -> tuple:
    """(entries off by more than OFF_TOL, entries, widest gap)."""
    gap = torch.abs(torch.as_tensor(np.asarray(got), device=want.device,
                                    dtype=want.dtype) - want)
    return int((gap > OFF_TOL).sum()), gap.numel(), float(gap.max())


# --------------------------------------------------------------------------
# pairwise: one subject registered to the template
# --------------------------------------------------------------------------

def pairwise_reference(subject: dict, template: dict, device,
                       prec=G.FLOAT64) -> dict:
    """What the reference makes of one subject's output sphere: the data
    resampled onto the template, the distortion statistics and the CC."""
    faces = _faces(subject["faces"], device)
    reg = prec(subject["reg_coords"], device)
    tfaces = _faces(template["faces"], device)
    out, outside = G.adaptive_resample(
        reg, faces, prec(subject["data"], device),
        prec(template["coords"], device), tfaces)
    areal, shape = G.distortion(prec(subject["coords"], device), reg, faces)
    stats = G.distortion_stats(areal, shape)
    stats["cc"] = G.pearson(out, prec(template["data"], device))
    return {"transformed": out, "stats": stats, "outside": outside}


def control_pairwise(subject: dict, template: dict, device) -> dict:
    """The control in the program's place: transformed data from TF32
    inputs in float32; the statistics in float32 (the CC of those
    transformed data)."""
    low = pairwise_reference(subject, template, device,
                             G.Precision(torch.float32, tf32_inputs=True))
    f32 = G.Precision(torch.float32)
    stats = pairwise_reference(subject, template, device, f32)["stats"]
    stats["cc"] = G.pearson(low["transformed"], f32(template["data"], device))
    return {"transformed": low["transformed"].cpu().numpy(), "stats": stats}


def judge_pairwise(subjects: list, template: dict, device,
                   bands: dict) -> dict:
    """subjects: dicts with the inputs (sid, coords, faces, data) and what
    the program gave (reg_coords and transformed, or None when missing;
    stats when the entry returns them); bands: see band_numbers. Returns
    the compared numbers and `info` (numbers printed, not compared)."""
    missing = folds = off = entries = outside = 0
    widest = cc_gap = dist_gap = 0.0
    gains, scores = [], {}
    for s in subjects:
        if s.get("reg_coords") is None or s.get("transformed") is None:
            missing += 1
            continue
        faces = _faces(s["faces"], device)
        orig = G.FLOAT64(s["coords"], device)
        reg = G.FLOAT64(s["reg_coords"], device)
        folds += G.folded_faces(reg, faces, G.face_orientation(orig, faces))
        ref = pairwise_reference(s, template, device)
        outside += ref["outside"]
        n_off, n, gap = _off(s["transformed"], ref["transformed"])
        off, entries, widest = off + n_off, entries + n, max(widest, gap)
        before = G.pearson(G.FLOAT64(s["data"], device),
                           G.FLOAT64(template["data"], device))
        gains.append(ref["stats"]["cc"] - before)
        if s.get("stats") is not None:
            # the program's CC of its own transformed data (float64 on the
            # host): the statistic's arithmetic, apart from the resampling
            own = G.pearson(G.FLOAT64(s["transformed"], device),
                            G.FLOAT64(template["data"], device))
            cc_gap = max(cc_gap, abs(s["stats"]["cc"] - own))
            dist_gap = max(dist_gap, _stat_gap(s["stats"], ref["stats"]))
        scores[s["sid"]] = {"cc": ref["stats"]["cc"],
                            "warp_ratio": warp_ratio(orig, reg, s["sid"])}
    numbers = {"missing": missing, "folds": folds,
               "resample_off_share": off / max(entries, 1),
               "cc_gain": min(gains) if gains else 0.0,
               **band_numbers(scores, bands)}
    if any(s.get("stats") is not None for s in subjects):
        numbers["cc_gap"] = cc_gap
        numbers["distortion_gap"] = dist_gap
    numbers["info"] = {"resample_widest_gap": widest,
                       "reference_points_outside": outside,
                       "cc_gains": gains, "subjects": scores}
    return numbers


# --------------------------------------------------------------------------
# groupwise: one gMSM cohort
# --------------------------------------------------------------------------

def _mean_pairwise_cc(maps) -> float:
    cs = [G.pearson(maps[i], maps[j]) for i in range(len(maps))
          for j in range(i + 1, len(maps))]
    return float(np.mean(cs))


def cohort_reference(cohort: dict, template: dict, device,
                     prec=G.FLOAT64) -> dict:
    """What the reference makes of one cohort's outputs: the dedrift of the
    registered spheres, the data resampled from the program's dedrifted
    spheres, the mean and stdev maps, the statistics."""
    faces = _faces(cohort["faces"], device)
    tfaces = _faces(template["faces"], device)
    tcoords = prec(template["coords"], device)
    original = prec(cohort["coords"], device)
    registered = [prec(c, device) for c in cohort["registered"]]
    avg = torch.stack(registered).mean(0)
    avg = avg / torch.linalg.norm(avg, dim=1, keepdim=True) * G.RAD
    dedrift, resampled, outside, dist = [], [], 0, []
    for s, reg in enumerate(registered):
        d, o = G.project_warp(reg, avg, faces, original)
        dedrift.append(d)
        ded_prog = prec(cohort["dedrifted"][s], device)
        out, o2 = G.adaptive_resample(ded_prog, faces,
                                      prec(cohort["data"][s], device),
                                      tcoords, tfaces)
        resampled.append(out)
        outside += o + o2
        dist.append(G.distortion_stats(*G.distortion(original, ded_prog,
                                                     faces)))
    stack = torch.stack(resampled)
    stats = {k: float(np.mean([d[k] for d in dist])) for k in STAT_KEYS}
    stats["cc"] = _mean_pairwise_cc([r[0] for r in resampled])
    return {"dedrifted": dedrift, "resampled": resampled,
            "mean": stack.mean(0), "stdev": stack.std(0, unbiased=False),
            "stats": stats, "outside": outside}


def control_cohort(cohort: dict, template: dict, device) -> dict:
    """The control in the program's place: dedrift and maps from TF32
    inputs in float32, statistics in float32."""
    low = cohort_reference(cohort, template, device,
                           G.Precision(torch.float32, tf32_inputs=True))
    f32 = G.Precision(torch.float32)
    stats = cohort_reference(cohort, template, device, f32)["stats"]
    stats["cc"] = _mean_pairwise_cc([r[0] for r in low["resampled"]])
    return {"dedrifted": [d.cpu().numpy() for d in low["dedrifted"]],
            "resampled": [r.cpu().numpy() for r in low["resampled"]],
            "mean": low["mean"].cpu().numpy(),
            "stdev": low["stdev"].cpu().numpy(), "stats": stats}


def judge_cohorts(cohorts: list, template: dict, device,
                  bands: dict) -> dict:
    """cohorts: dicts with the inputs (sids, coords, faces, data list) and
    what the program gave (registered: the spheres it wrote before the
    dedrift; dedrifted, resampled, mean, stdev, stats), or missing=True;
    bands: see band_numbers (a subject scored on its dedrifted sphere)."""
    missing = folds = off = entries = maps_off = maps_n = outside = 0
    ded_off = ded_n = 0
    ded_gap = cc_gap = dist_gap = widest = 0.0
    gains, scores = [], {}
    for c in cohorts:
        if c.get("missing"):
            missing += len(c["sids"])
            continue
        faces = _faces(c["faces"], device)
        orig = G.FLOAT64(c["coords"], device)
        orient = G.face_orientation(orig, faces)
        tdata = G.FLOAT64(template["data"], device)
        ref = cohort_reference(c, template, device)
        outside += ref["outside"]
        for s in range(len(c["sids"])):
            prog = G.FLOAT64(c["dedrifted"][s], device)
            folds += G.folded_faces(prog, faces, orient)
            dist = torch.linalg.norm(prog - ref["dedrifted"][s], dim=1)
            ded_gap = max(ded_gap, float(dist.max()))
            ded_off += int((dist > DEDRIFT_TOL_MM).sum())
            ded_n += dist.numel()
            n_off, n, gap = _off(c["resampled"][s], ref["resampled"][s])
            off, entries, widest = off + n_off, entries + n, max(widest, gap)
            scores[c["sids"][s]] = {
                "cc": G.pearson(ref["resampled"][s], tdata),
                "warp_ratio": warp_ratio(orig, prog, c["sids"][s])}
        for name in ("mean", "stdev"):
            n_off, n, _ = _off(c[name], ref[name])
            maps_off, maps_n = maps_off + n_off, maps_n + n
        own = _mean_pairwise_cc([G.FLOAT64(r[0], device)
                                 for r in c["resampled"]])
        cc_gap = max(cc_gap, abs(c["stats"]["cc"] - own))
        dist_gap = max(dist_gap, _stat_gap(c["stats"], ref["stats"]))
        before = _mean_pairwise_cc([G.FLOAT64(d[0], device)
                                    for d in c["data"]])
        gains.append(ref["stats"]["cc"] - before)
    return {"missing": missing, "folds": folds,
            "dedrift_off_share": ded_off / max(ded_n, 1),
            "resample_off_share": off / max(entries, 1),
            "maps_off_share": maps_off / max(maps_n, 1),
            "cc_gap": cc_gap, "distortion_gap": dist_gap,
            "cc_gain": min(gains) if gains else 0.0,
            **band_numbers(scores, bands),
            "info": {"resample_widest_gap": widest,
                     "dedrift_widest_gap_mm": ded_gap,
                     "reference_points_outside": outside,
                     "cc_gains": gains, "subjects": scores}}


# --------------------------------------------------------------------------
# limits
# --------------------------------------------------------------------------

def checks(numbers: dict, limits: dict) -> tuple:
    """Each compared number beside its limit. limits: {name: {"max": x} or
    {"min": x}}. Returns (ok, {name: {"value", "limit", "ok"}}); a number
    without a limit in `limits` fails (the limits file must name every
    number the judge gives)."""
    out, ok = {}, True
    for name, value in numbers.items():
        if name == "info":
            continue
        lim = limits.get(name)
        if lim is None:
            good, limit = False, None
        elif "max" in lim:
            limit = lim["max"]
            good = value <= limit
        else:
            limit = lim["min"]
            good = value >= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit,
                     "ok": bool(good),
                     "kind": None if lim is None else
                     ("max" if "max" in lim else "min")}
    return ok, out
