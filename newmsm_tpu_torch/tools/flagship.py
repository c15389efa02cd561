"""End-to-end runs of the reference's flagship recipe families by
newmsm_tpu_torch: the protocol of scripts/flagship_recipes.py.

    python -m newmsm_tpu_torch.tools.flagship [--device cuda] [--fast]
        [--it N] [--phases amsm,multimodal] [--out FILE.json]

  amsm        the structure of the aMSM longitudinal recipe
              (NeuroImage2017 aMSM_STR_longitudinal_alignment: regoption 5,
              triclique, three levels CP 2/3/4, SG / data / anatomical grids
              4/5/6; AMSM_CONFIG) on longitudinal_pair(res, seed=0) with
              both anatomies, res 6;
  multimodal  the structure of the HCP multimodal recipe
              (HCP_multimodal_alignment MSMAllStrainFinalconf1to1_1to3_2:
              regoption 3 with the triclique data term, the same three
              levels without the anatomical grid; MULTIMODAL_CONFIG) on
              multimodal_cohort(res, S, n_channels=D, seed=0), each subject
              registered to the template, res, S, D = 6, 3, 10.

Both configs carry the strain parameters of config_standard_MSM_strain and
10 iterations a level (the driver's convergence test ends a level earlier).
They are NOT the reference's config files verbatim: those files are not in
the repository. --fast takes the script's fast cut (2 iterations a level,
CP grids at most ico-2, data / SG / anatomical grids at most ico-3; res 4
for amsm, res, S, D = 3, 2, 6 for multimodal); --it sets every level of
both configs to N iterations.

Rows (the script's keys, plus folds and energies_finite): amsm
cc_sulc_before/after, anat_radial_cc_before/after (the registered anatomy's
radial profile against the input anatomy's, vertex for vertex),
strain_rows_finite, the distortion statistics, wall_s; multimodal
cc_before_mean / cc_after_mean and both per-channel lists (CC of each
subject's channel to the template's, averaged over subjects), the
distortion statistics averaged over subjects, wall_s_per_subject.

It prints the rows beside flagship_full.json (flagship_fast.json with
--fast; at the repository root, never written), by pattern only: the JAX
rows ran the reference's config files verbatim. Gates, which make the exit
code 1: 0 folds, CC raised (multimodal: the mean and every channel), finite
energies; amsm: the anatomical radial CC raised and a finite 4-row
STRAINS.func.gii.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

FULL_ITERS = "10,10,10"
AMSM_CONFIG = """\
--simval=2,2,2
--sigma_in=2,2,1
--sigma_ref=2,2,1
--lambda=0.2,0.2,0.2
--it={iters}
--opt=DISCRETE,DISCRETE,DISCRETE
--CPgrid=2,3,4
--SGgrid=4,5,6
--datagrid=4,5,6
--anatgrid=4,5,6
--regoption=5
--triclique
--regexp=2
--dopt=HOCR
--VN
--k_exponent=2
--bulkmod=1.6
--shearmod=0.4
"""
MULTIMODAL_CONFIG = AMSM_CONFIG.replace("--anatgrid=4,5,6\n", "").replace(
    "--regoption=5", "--regoption=3")
CONFIGS = {"amsm": AMSM_CONFIG, "multimodal": MULTIMODAL_CONFIG}
PHASES = tuple(CONFIGS)
# the reference's recipe files whose structure each config takes
RECIPES = {"amsm": "aMSM_STR_longitudinal_alignment",
           "multimodal": "MSMAllStrainFinalconf1to1_1to3_2"}
PATTERN_ONLY = ("pattern only: the JAX rows ran the reference's config files "
                "verbatim, which are not in the repository")


def config(phase: str, fast: bool = False, iters: int | None = None):
    """The phase's RegConfig: the script's fast cut with `fast`; `iters`
    sets every level's iterations."""
    from ..reg.config import parse_config
    with tempfile.TemporaryDirectory(prefix="flagship_conf_") as d:
        path = os.path.join(d, f"{phase}.conf")
        with open(path, "w") as f:
            f.write(CONFIGS[phase].format(iters=FULL_ITERS))
        cfg = parse_config(path)
    if fast:
        cfg.iters = [2] * len(cfg.iters)
        cfg.cpgrid = [min(g, 2) for g in cfg.cpgrid]
        cfg.datagrid = [min(g, 3) for g in cfg.datagrid]
        cfg.sampgrid = [min(g, 3) for g in cfg.sampgrid]
        if cfg.anatgrid:
            cfg.anatgrid = [min(g, 3) for g in cfg.anatgrid]
    if iters is not None:
        cfg.iters = [iters] * len(cfg.iters)
    return cfg


def _register(in_mesh, in_data, ref_mesh, ref_data, cfg, device, outdir,
              anat=None):
    """One pairwise run; (driver, folds, energies finite, iterations a
    level)."""
    from ..ops.unfold import count_folds
    from ..reg.driver import MeshRegistration
    mr = MeshRegistration(device=device)
    mr.set_input(in_mesh)
    mr.set_input_data(in_data)
    mr.set_reference(ref_mesh)
    mr.set_reference_data(ref_data)
    if anat is not None:
        mr.set_anatomical(*anat)
    mr.outdir = outdir
    mr.run_multiresolutions(cfg)
    energies = [e for *_, e in mr.energy_log]
    levels = [lv for lv, *_ in mr.energy_log]
    iters = [levels.count(lv) for lv in sorted(set(levels))]
    return (mr, count_folds(mr.warped_input, device=device),
            bool(np.isfinite(energies).all()), iters)


def run_amsm(cfg, res: int, device) -> dict:
    """The aMSM row on longitudinal_pair(res, seed=0) (the script's
    run_amsm)."""
    from ..core import io as mio
    from ..core.mesh import Mesh
    from ..eval import metrics
    from ..eval.synth import longitudinal_pair
    in_mesh, in_data, in_anat, ref_mesh, ref_data, ref_anat = \
        longitudinal_pair(res, seed=0)
    with tempfile.TemporaryDirectory(prefix="flagship_amsm_") as d:
        t0 = time.perf_counter()
        mr, folds, finite, iters = _register(
            in_mesh, in_data, ref_mesh, ref_data, cfg, device, d + "/",
            anat=(in_anat, ref_anat))
        wall = time.perf_counter() - t0
        anat_reg = Mesh.load(os.path.join(d, "anat.reg.surf.gii"))
        strains = mio.load_data(os.path.join(d, "STRAINS.func.gii"), in_mesh)
    dist = metrics.distortion_stats(*metrics.distortion_maps(
        mr.in_mesh, mr.warped_input))
    r_in = np.linalg.norm(in_anat.coords, axis=1)
    return {
        "config": f"{RECIPES['amsm']} (structure)", "res": res,
        "wall_s": wall,
        "cc_sulc_before": metrics.cross_correlation(in_data[0], ref_data[0]),
        "cc_sulc_after": metrics.cross_correlation(
            np.asarray(mr.transformed_data)[0], ref_data[0]),
        "anat_radial_cc_before": metrics.cross_correlation(
            np.linalg.norm(ref_anat.coords, axis=1), r_in),
        "anat_radial_cc_after": metrics.cross_correlation(
            np.linalg.norm(anat_reg.coords, axis=1), r_in),
        "strain_rows_finite": bool(strains.shape == (4, in_mesh.nvertices)
                                   and np.isfinite(strains).all()),
        **dist, "folds": folds, "energies_finite": finite,
        "iterations": iters}


def run_multimodal(cfg, res: int, S: int, D: int, device) -> dict:
    """The multimodal row on multimodal_cohort(res, S, n_channels=D,
    seed=0), each subject to the template (the script's run_multimodal)."""
    from ..eval import metrics
    from ..eval.synth import multimodal_cohort
    meshes, datasets, template_data = multimodal_cohort(res, S, n_channels=D,
                                                        seed=0)
    maps, dists, walls, folds, iters, finite = [], [], [], [], [], True
    with tempfile.TemporaryDirectory(prefix="flagship_multi_") as d:
        for s in range(S):
            t0 = time.perf_counter()
            mr, f, fin, it = _register(
                meshes[s].copy(), datasets[s], meshes[s].copy(),
                template_data, cfg, device, os.path.join(d, f"s{s}."))
            walls.append(time.perf_counter() - t0)
            maps.append(np.asarray(mr.transformed_data))
            dists.append(metrics.distortion_stats(*metrics.distortion_maps(
                mr.in_mesh, mr.warped_input)))
            folds.append(f)
            iters.append(it)
            finite &= fin
            print(f"  multimodal subject {s}: {walls[-1]:.2f} s, {f} folds, "
                  f"iterations by level {it}", flush=True)

    def mean_cc(data, d):
        return float(np.mean([metrics.cross_correlation(data[s][d],
                                                        template_data[d])
                              for s in range(S)]))

    before = [mean_cc(datasets, d) for d in range(D)]
    after = [mean_cc(maps, d) for d in range(D)]
    out = {"config": f"{RECIPES['multimodal']} (structure)", "res": res,
           "S": S, "D": D, "wall_s_per_subject": float(np.mean(walls)),
           "cc_before_mean": float(np.mean(before)),
           "cc_after_mean": float(np.mean(after)),
           "cc_after_per_channel": after, "cc_before_per_channel": before}
    for key in dists[0]:
        out[key] = float(np.mean([x[key] for x in dists]))
    return dict(out, folds=folds, energies_finite=finite, iterations=iters)


def gates(out: dict) -> list:
    """The failed gates of a result (empty when every gate holds)."""
    fails = []
    a = out.get("amsm")
    if a is not None:
        if a["folds"]:
            fails.append(f"amsm: {a['folds']} folds")
        if not a["cc_sulc_after"] > a["cc_sulc_before"]:
            fails.append(f"amsm: cc_sulc {a['cc_sulc_after']} not above "
                         f"{a['cc_sulc_before']}")
        if not a["anat_radial_cc_after"] > a["anat_radial_cc_before"]:
            fails.append(f"amsm: anatomical radial CC "
                         f"{a['anat_radial_cc_after']} not above "
                         f"{a['anat_radial_cc_before']}")
        if not a["strain_rows_finite"]:
            fails.append("amsm: STRAINS.func.gii is not 4 finite rows")
        if not a["energies_finite"]:
            fails.append("amsm: an energy is not finite")
    m = out.get("multimodal")
    if m is not None:
        if sum(m["folds"]):
            fails.append(f"multimodal: folds by subject {m['folds']}")
        if not m["cc_after_mean"] > m["cc_before_mean"]:
            fails.append(f"multimodal: mean CC {m['cc_after_mean']} not "
                         f"above {m['cc_before_mean']}")
        lowered = [d for d, (b, c) in enumerate(zip(
            m["cc_before_per_channel"], m["cc_after_per_channel"]))
            if not c > b]
        if lowered:
            fails.append(f"multimodal: CC not raised on channels {lowered}")
        if not m["energies_finite"]:
            fails.append("multimodal: an energy is not finite")
    return fails


def compare(out: dict, ref: dict | None) -> list:
    """Lines of each row beside the JAX package's recorded row, by pattern
    only (CC and distortion; the JAX walls are a TPU's, not targets)."""
    if ref is None:
        return ["no recorded JAX rows to compare with"]
    lines = [PATTERN_ONLY]
    if out.get("it") is not None:
        lines.append(f"iterations cut to {out['it']} a level")
    a, want = out.get("amsm"), ref.get("amsm")
    if a is not None and want is not None:
        lines.append(
            f"amsm (ico-{a['res']}; JAX ico-{want['res']}): cc_sulc port "
            f"{a['cc_sulc_before']:.4f} -> {a['cc_sulc_after']:.4f}, JAX "
            f"{want['cc_sulc_before']:.4f} -> {want['cc_sulc_after']:.4f}; "
            f"anatomical radial CC port {a['anat_radial_cc_before']:.4f} -> "
            f"{a['anat_radial_cc_after']:.4f}, JAX "
            f"{want['anat_radial_cc_before']:.4f} -> "
            f"{want['anat_radial_cc_after']:.4f}; areal_mean port "
            f"{a['areal_mean']:.4f} JAX {want['areal_mean']:.4f}, areal_max "
            f"port {a['areal_max']:.4f} JAX {want['areal_max']:.4f}")
    m, want = out.get("multimodal"), ref.get("multimodal")
    if m is not None and want is not None:
        lines.append(
            f"multimodal (ico-{m['res']}, S={m['S']}, D={m['D']}; JAX "
            f"ico-{want['res']}, S={want['S']}, D={want['D']}): mean CC port "
            f"{m['cc_before_mean']:.4f} -> {m['cc_after_mean']:.4f}, JAX "
            f"{want['cc_before_mean']:.4f} -> {want['cc_after_mean']:.4f}; "
            f"areal_mean port {m['areal_mean']:.4f} JAX "
            f"{want['areal_mean']:.4f}, areal_max port {m['areal_max']:.4f} "
            f"JAX {want['areal_max']:.4f}")
        lines.append("multimodal CC after by channel: port "
                     f"{[round(c, 4) for c in m['cc_after_per_channel']]}, "
                     f"JAX {want['cc_after_per_channel']}")
    return lines


def report(out: dict) -> int:
    """Print the rows beside flagship_fast.json (a --fast result) or
    flagship_full.json at the repository root, and the gates; the exit
    code."""
    ref = None
    reference = os.path.join(ROOT, "flagship_fast.json" if out["fast"]
                             else "flagship_full.json")
    if os.path.exists(reference):
        with open(reference) as f:
            ref = json.load(f)
    for line in compare(out, ref):
        print(line)
    fails = gates(out)
    for fail in fails:
        print(f"GATE FAILED: {fail}")
    print("gates: " + ("FAILED" if fails else "all met"))
    return 1 if fails else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fast", action="store_true",
                    help="the script's fast cut")
    ap.add_argument("--it", type=int, default=None,
                    help="iterations of every level of both configs")
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)

    from .. import resolve_device
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    device = resolve_device(args.device)
    if device.type == "cuda":
        import subprocess
        import torch
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True)
        print(f"device {torch.cuda.get_device_name(device)}; nvidia-smi: "
              f"{smi.stdout.strip()}", flush=True)
    out = {"fast": args.fast, "it": args.it, "device": str(device)}
    for phase in phases:
        cfg = config(phase, args.fast, args.it)
        print(f"{phase}: the structure of {RECIPES[phase]}, iterations "
              f"{cfg.iters}, CP {cfg.cpgrid}, data {cfg.datagrid}", flush=True)
        t0 = time.perf_counter()
        if phase == "amsm":
            row = run_amsm(cfg, 4 if args.fast else 6, device)
        else:
            res, S, D = (3, 2, 6) if args.fast else (6, 3, 10)
            row = run_multimodal(cfg, res, S, D, device)
        out[phase] = row
        print(f"{phase} ({time.perf_counter() - t0:.2f} s): "
              f"{json.dumps(row)}", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
    return report(out)


if __name__ == "__main__":
    sys.exit(main())
