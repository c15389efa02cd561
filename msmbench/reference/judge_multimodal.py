"""The numbers that decide `correct` in a multimodal pairwise cell: those of
a pairwise cell (judge.py), over every channel, and the triclique
likelihood held against its plain reference (triclique.py).

- missing, folds, cc_gap, distortion_gap: as judge.judge_pairwise gives
  them (the program's CC is over all channels, flattened, as its
  register_dataset reports it);
- resample_off_share: over every channel of the resampled maps;
- cc_gain: the least over the subjects of the CC gain averaged over the
  channels;
- cc_drop / warp_rise: each subject's channel-mean CC and warp ratio
  against what it reads in sound runs (the cell's bands); the warp is the
  multimodal generator's own, the one every channel of a subject rides
  (synth_multimodal.true_warp, which is synth.true_warp: judge.warp_ratio
  reads it);
- lik_off_share: the share of the entries of the likelihood calls the
  entry kept (the last (T,8) call of each unit's last level) further than
  LIK_TOL from the float64 reference on the same inputs; a registered
  subject whose unit kept no call counts a whole call off (as many entries
  as a kept call has, or 1 where none was kept);
- lik_missing: the registered subjects whose unit kept no call;
- patch_off: over the kept calls, the source vertices not in exactly one
  masked-in slot of the face patches and the masked-in slots whose vertex
  lies outside its CP triangle (triclique.patch_faults): what a full
  patch drops, or a wrong patch build misplaces.

`control` puts the reference one precision lower in the program's place:
for the likelihood, float32 from TF32-rounded inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from . import geometry as G
from . import judge
from . import triclique as TQ
from .. import synth_multimodal as SM

# a likelihood entry is "off" when it is further than this from the
# reference's: the entries are similarities in [0, 1] times absolute
# weights near 1; float32 with the program's locate puts it within ~7e-6
# (a channel vector of near-zero variance at a vertex is the worst), and
# target data rounded to bfloat16 moves entries by 3e-4 to 2e-2
LIK_TOL = 1e-4


def channel_cc(a, b) -> float:
    """The Pearson CC of each channel, averaged over the channels."""
    return float(np.mean([G.pearson(a[d], b[d]) for d in range(a.shape[0])]))


def likelihood_numbers(liks: list, device, control: bool = False) -> dict:
    """liks: per registered subject the kept call (a dict of the
    likelihood's inputs, `target_res` and the program's output `out`), or
    None. Returns the entries off, the entries, the calls missing, the
    widest gap, the points no target face held, and the face patches'
    faults (patch_off) with their least barycentric weight."""
    off = entries = outside = unplaced = misplaced = 0
    widest, least_weight = 0.0, 1.0
    missing = sum(rec is None for rec in liks)
    for rec in liks:
        if rec is None:
            continue
        rec = {k: v.cpu() if isinstance(v, torch.Tensor) else v
               for k, v in rec.items()}
        patches = TQ.patch_faults(rec["cp"], rec["triplets"],
                                  rec["face_idx"], rec["face_mask"],
                                  rec["src"], device=device)
        unplaced += patches["unplaced"]
        misplaced += patches["outside"]
        least_weight = min(least_weight, patches["least_weight"])
        coords, faces = SM.icosphere(rec["target_res"])
        args = (rec["cp"], rec["rl"], rec["triplets"], rec["face_idx"],
                rec["face_mask"], rec["src"], rec["abs_weights"],
                rec["cfweights"], rec["source_data"], coords, faces,
                rec["target_data"], rec["la"], rec["lb"], rec["lc"],
                rec["simval"], rec["multivariate"])
        ref = TQ.likelihood(*args, prec=TQ.FLOAT64, device=device)
        got = (TQ.likelihood(*args, prec=TQ.CONTROL, device=device)["lik"]
               if control else rec["out"])
        gap = torch.abs(got.to(device=device, dtype=torch.float64)
                        - ref["lik"])
        off += int((gap > LIK_TOL).sum())
        entries += gap.numel()
        widest = max(widest, float(gap.max()))
        outside += ref["outside"]
    per_call = entries // max(len(liks) - missing, 1) or 1
    return {"off": off + missing * per_call,
            "entries": entries + missing * per_call, "missing": missing,
            "widest": widest, "outside": outside,
            "patch_off": unplaced + misplaced, "patch_unplaced": unplaced,
            "patch_outside": misplaced, "least_weight": least_weight}


def judge_multimodal(subjects: list, template: dict, device, bands: dict,
                     liks: list, control: bool = False) -> dict:
    """subjects: as judge.judge_pairwise takes them, with (D,N) data;
    liks: per subject the kept likelihood call (see likelihood_numbers)."""
    missing = folds = off = entries = outside = 0
    widest = cc_gap = dist_gap = 0.0
    gains, scores, kept = [], {}, []
    tdata = G.FLOAT64(template["data"], device)
    for s, rec in zip(subjects, liks):
        if s.get("reg_coords") is None or s.get("transformed") is None:
            missing += 1
            continue
        kept.append(rec)
        faces = judge._faces(s["faces"], device)
        orig = G.FLOAT64(s["coords"], device)
        reg = G.FLOAT64(s["reg_coords"], device)
        folds += G.folded_faces(reg, faces, G.face_orientation(orig, faces))
        ref = judge.pairwise_reference(s, template, device)
        outside += ref["outside"]
        n_off, n, gap = judge._off(s["transformed"], ref["transformed"])
        off, entries, widest = off + n_off, entries + n, max(widest, gap)
        after = channel_cc(ref["transformed"], tdata)
        gains.append(after - channel_cc(G.FLOAT64(s["data"], device), tdata))
        if s.get("stats") is not None:
            own = G.pearson(G.FLOAT64(s["transformed"], device), tdata)
            cc_gap = max(cc_gap, abs(s["stats"]["cc"] - own))
            dist_gap = max(dist_gap,
                           judge._stat_gap(s["stats"], ref["stats"]))
        scores[s["sid"]] = {"cc": after, "warp_ratio": judge.warp_ratio(
            orig, reg, s["sid"])}
    lik = likelihood_numbers(kept, device, control)
    numbers = {"missing": missing, "folds": folds,
               "resample_off_share": off / max(entries, 1),
               "cc_gain": min(gains) if gains else 0.0,
               **judge.band_numbers(scores, bands),
               "lik_off_share": lik["off"] / max(lik["entries"], 1),
               "lik_missing": lik["missing"], "patch_off": lik["patch_off"]}
    if any(s.get("stats") is not None for s in subjects):
        numbers["cc_gap"] = cc_gap
        numbers["distortion_gap"] = dist_gap
    numbers["info"] = {"resample_widest_gap": widest,
                       "reference_points_outside": outside,
                       "lik_widest_gap": lik["widest"],
                       "lik_entries": lik["entries"],
                       "lik_points_outside": lik["outside"],
                       "patch_unplaced": lik["patch_unplaced"],
                       "patch_outside": lik["patch_outside"],
                       "patch_least_weight": lik["least_weight"],
                       "cc_gains": gains, "subjects": scores}
    return numbers
