"""Registration quality of the port against the JAX package's recorded
rows: the protocol of scripts/parity_harness.py (the reference's
gMSM-vs-typical evaluation, gMSM_scripts/gMSM_tutorial/compare_stats.py)
run by newmsm_tpu_torch.

    python -m newmsm_tpu_torch.tools.parity [--device cuda] [--subjects 6]
        [--res 6] [--fast] [--it N] [--phases typical,msmpair,groupwise]
        [--group-ranks W] [--out FILE.json] [--metrics FILE.jsonl]

On synth_cohort(res, S, seed=0) (sulc + curv):
  typical    each subject registered pairwise to the group template with
             config_standard_MSM_strain (TYPICAL_CONFIG);
  msmpair    the same with config_standard_MSMpair (MSMPAIR_CONFIG);
  groupwise  pipelines.gmsm.run_gmsm with the gMSM tutorial config
             (GROUPWISE_CONFIG) and dedrift; with --group-ranks W, over W
             ranks spawned by multihost.run_local_ranks (gloo when ranks
             share a card or run on the CPU, NCCL with a card a rank).
Each row: mean pairwise CC and DICE per channel of the resampled maps, the
|log2| areal / shape distortion means, folds of every output sphere,
whether every energy was finite, and the wall. --fast takes the harness's
FAST_* configs. --it sets every level of every config to N iterations.
--metrics keeps the groupwise driver's JSONL events and prints its
setup_s / opt_s, pair-block batches and peak device memory.

It prints each row beside the JAX package's recorded row (parity_full.json,
or parity_fast.json with --fast, at the repository root; it never writes
them): |delta cc_sulc| and the areal_mean ratio. The JAX package's msmpair
row was made with the reference's own config file, which is not in the
repository, so that row is compared by pattern only. Gates, which make the
exit code 1: 0 folds in every output sphere, every row's cc_sulc above the
unregistered cohort's, groupwise cc_sulc >= typical cc_sulc (the protocol's
published pattern), finite energies.
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

# config texts of scripts/parity_harness.py, copied (the port imports
# nothing of the JAX package's tree)
TYPICAL_CONFIG = """\
--simval=2,2,2,2
--sigma_in=2,4,2,1
--sigma_ref=2,4,2,1
--lambda=0,0.2,0.2,0.2
--it=50,20,25,25
--opt=AFFINE,DISCRETE,DISCRETE,DISCRETE
--CPgrid=0,2,3,4
--SGgrid=0,4,5,6
--datagrid=5,5,5,6
--regoption=3
--regexp=2
--dopt=HOCR
--VN
--k_exponent=2
--bulkmod=1.6
--shearmod=0.4
--rescaleL
"""
# config/basic_configs/config_standard_MSM_strain

GROUPWISE_CONFIG = """\
--simval=2,2,2
--sigma_in=0,0,0
--sigma_ref=0,0,0
--lambda=0.3,0.3,0.3
--it=9,9,9
--opt=DISCRETE,DISCRETE,DISCRETE
--CPgrid=2,3,4
--SGgrid=4,5,6
--datagrid=4,5,6
--regoption=3
--regexp=2
--dopt=HOCR
--k_exponent=2
--bulkmod=1.6
--shearmod=0.4
"""
# the gMSM tutorial example config (docs/guide.md:394-411) with lambda 0.3

MSMPAIR_CONFIG = """\
--sigma_in=6,6,4,2
--sigma_ref=6,6,4,2
--lambda=0,0.1,0.2,0.3
--it=50,5,10,10
--opt=AFFINE,DISCRETE,DISCRETE,DISCRETE
--CPgrid=0,2,3,4
--SGgrid=0,4,5,6
--datagrid=5,5,5,6
--regoption=1
"""
# config_standard_MSMpair as scripts/parity_harness.py writes it

FAST_TYPICAL = TYPICAL_CONFIG.replace(
    "--it=50,20,25,25", "--it=20,4,4,4").replace(
    "--datagrid=5,5,5,6", "--datagrid=3,3,4,4").replace(
    "--CPgrid=0,2,3,4", "--CPgrid=0,1,2,2").replace(
    "--SGgrid=0,4,5,6", "--SGgrid=0,3,4,4").replace(
    "--sigma_in=2,4,2,1", "--sigma_in=2,4,2,2").replace(
    "--sigma_ref=2,4,2,1", "--sigma_ref=2,4,2,2")

FAST_GROUPWISE = GROUPWISE_CONFIG.replace(
    "--it=9,9,9", "--it=4,4,4").replace(
    "--datagrid=4,5,6", "--datagrid=3,4,4").replace(
    "--CPgrid=2,3,4", "--CPgrid=1,2,2").replace(
    "--SGgrid=4,5,6", "--SGgrid=3,4,4")

FAST_MSMPAIR = MSMPAIR_CONFIG.replace(
    "--it=50,5,10,10", "--it=20,3,3,3").replace(
    "--datagrid=5,5,5,6", "--datagrid=3,3,4,4").replace(
    "--CPgrid=0,2,3,4", "--CPgrid=0,1,2,2").replace(
    "--SGgrid=0,4,5,6", "--SGgrid=0,3,4,4").replace(
    "--sigma_in=6,6,4,2", "--sigma_in=4,4,2,2").replace(
    "--sigma_ref=6,6,4,2", "--sigma_ref=4,4,2,2")

CONFIGS = {"typical": (TYPICAL_CONFIG, FAST_TYPICAL),
           "msmpair": (MSMPAIR_CONFIG, FAST_MSMPAIR),
           "groupwise": (GROUPWISE_CONFIG, FAST_GROUPWISE)}
PHASES = tuple(CONFIGS)
# |delta cc_sulc| against the JAX package's row above which the gap is a
# fault to record (typical and groupwise rows)
CC_BAND = 0.03


def config(phase: str, fast: bool = False, iters: int | None = None):
    """The phase's RegConfig; `iters` sets every level's iterations."""
    from ..reg.config import parse_config
    with tempfile.TemporaryDirectory(prefix="parity_conf_") as d:
        path = os.path.join(d, f"{phase}.conf")
        with open(path, "w") as f:
            f.write(CONFIGS[phase][int(fast)])
        cfg = parse_config(path)
    if iters is not None:
        cfg.iters = [iters] * len(cfg.iters)
    return cfg


def channel_stats(maps, percentile=75.0) -> dict:
    """Per-channel mean pairwise CC and DICE (compare_stats.py:44-66)."""
    from ..eval import metrics
    out = {}
    for d, name in enumerate(("sulc", "curv")):
        ch = [m[d] for m in maps]
        out[f"cc_{name}"] = metrics.mean_pairwise_cc(ch)
        out[f"dice_{name}"] = metrics.mean_pairwise_dice(ch, percentile)
    return out


def _with_distortion(stats: dict, pairs) -> dict:
    """stats plus the means over subjects of the distortion statistics of
    each (original, registered) mesh pair."""
    from ..eval import metrics
    dists = [metrics.distortion_stats(*metrics.distortion_maps(o, r))
             for o, r in pairs]
    for key in dists[0]:
        stats[key] = float(np.mean([d[key] for d in dists]))
    return stats


def run_pairwise(meshes, datasets, template_data, cfg, device) -> dict:
    """Every subject registered pairwise to the template data (the
    harness's run_typical)."""
    from ..ops.unfold import count_folds
    from ..reg.driver import MeshRegistration
    maps, pairs, folds, finite = [], [], [], True
    with tempfile.TemporaryDirectory(prefix="parity_pair_") as d:
        for s in range(len(meshes)):
            t0 = time.perf_counter()
            mr = MeshRegistration(device=device)
            mr.set_input(meshes[s].copy())
            mr.set_reference(meshes[s].copy())
            mr.set_input_data(datasets[s])
            mr.set_reference_data(template_data)
            mr.outdir = os.path.join(d, f"s{s}.")
            mr.run_multiresolutions(cfg)
            maps.append(np.asarray(mr.transformed_data))
            pairs.append((mr.in_mesh, mr.warped_input))
            folds.append(count_folds(mr.warped_input, device=device))
            finite &= bool(np.isfinite([e for *_, e in mr.energy_log]).all())
            print(f"  subject {s}: {time.perf_counter() - t0:.2f} s, "
                  f"{folds[-1]} folds", flush=True)
    stats = _with_distortion(channel_stats(maps), pairs)
    return dict(stats, folds=folds, energies_finite=finite)


def _groupwise_stats(meshes, res, device) -> dict:
    from ..ops.unfold import count_folds
    stats = _with_distortion(channel_stats(res.resampled_data),
                             zip(meshes, res.dedrifted_spheres))
    return dict(stats, folds=[count_folds(m, device=device)
                              for m in res.dedrifted_spheres],
                energies_finite=bool(np.isfinite(
                    [e for *_, e in res.energies]).all()))


def _groupwise_rank(meshes, datasets, template, cfg, device, metrics_path):
    """One rank of the groupwise phase (spawned): run_gmsm over the world on
    this rank's device."""
    import torch.distributed as dist
    from ..parallel import multihost as mh
    from ..pipelines.gmsm import run_gmsm
    device = mh.rank_device(device)
    res = run_gmsm(meshes, datasets, template, cfg, device=device,
                   group=dist.group.WORLD, metrics_path=metrics_path)
    return _groupwise_stats(meshes, res, device)


def run_groupwise(meshes, datasets, template, cfg, device,
                  ranks: int = 1, metrics_path: str | None = None) -> dict:
    """run_gmsm with dedrift (the harness's run_groupwise), in this process
    or over `ranks` spawned ranks (rank 0's row; every rank's must be the
    same); `metrics_path`: the driver's JSONL events."""
    from ..pipelines.gmsm import run_gmsm
    if ranks == 1:
        res = run_gmsm([m.copy() for m in meshes],
                       [d.copy() for d in datasets], template, cfg,
                       device=device,
                       metrics_path=metrics_path)
        return _groupwise_stats(meshes, res, device)
    import torch
    from ..parallel import multihost as mh
    cuda = torch.device(device).type == "cuda"
    backend = ("nccl" if cuda and torch.cuda.device_count() >= ranks
               else "gloo")
    # on the CPU the ranks split this process's threads
    threads = None if cuda else max(1, torch.get_num_threads() // ranks)
    rows = mh.run_local_ranks(_groupwise_rank, ranks, backend=backend,
                              timeout=3000, threads=threads,
                              args=(meshes, datasets, template, cfg, device,
                                    metrics_path))
    if any(r != rows[0] for r in rows):
        raise RuntimeError(f"ranks disagree: {rows}")
    print(f"  {ranks} ranks, backend {backend}", flush=True)
    return rows[0]


def print_group_metrics(metrics_path: str) -> None:
    """The groupwise driver's per-iteration and per-rank lines."""
    with open(metrics_path) as f:
        events = [json.loads(line) for line in f]
    for e in events:
        if e["event"] == "iter":
            print(f"  level {e['level']} it {e['iter']}: energy "
                  f"{e['energy']:.6f} setup_s {e['setup_s_by_rank']} opt_s "
                  f"{e['opt_s_by_rank']} pmax {e['pmax']} patch_overflow "
                  f"{e['patch_overflow']} pair-block batches "
                  f"{e['pair_chunks_by_rank']} of {e['pair_chunk_blocks']}")
        elif e["event"] == "level":
            print(f"  level {e['level']}: wall {e['wall_s']} s")
        elif e["event"] == "ranks":
            print(f"  K1 launches by rank {e['locate_launches']}; peak device "
                  f"bytes by rank {e['peak_device_bytes']}")


def gates(out: dict) -> list:
    """The failed gates of a result (empty when every gate holds)."""
    fails = []
    before = out["before"]["cc_sulc"]
    for phase in PHASES:
        row = out.get(phase)
        if row is None:
            continue
        if sum(row["folds"]):
            fails.append(f"{phase}: folds by subject {row['folds']}")
        if not row["cc_sulc"] > before:
            fails.append(f"{phase}: cc_sulc {row['cc_sulc']} not above the "
                         f"unregistered {before}")
        if not row["energies_finite"]:
            fails.append(f"{phase}: an energy is not finite")
    if "typical" in out and "groupwise" in out and \
            out["groupwise"]["cc_sulc"] < out["typical"]["cc_sulc"]:
        fails.append(f"groupwise cc_sulc {out['groupwise']['cc_sulc']} below "
                     f"typical {out['typical']['cc_sulc']}")
    return fails


def compare(out: dict, ref: dict | None) -> list:
    """Lines of each row beside the JAX package's recorded row."""
    if ref is None:
        return ["no recorded JAX rows to compare with"]
    lines = []
    same = all(ref.get(k) == out[k] for k in ("S", "res", "fast"))
    if not same:
        lines.append(f"the recorded JAX rows are of S={ref.get('S')} "
                     f"res={ref.get('res')} fast={ref.get('fast')}: not this "
                     "cohort, printed for reference only")
    if out.get("it") is not None:
        lines.append(f"iterations cut to {out['it']} a level: the recorded "
                     "rows ran the configs' full iterations")
    for phase in ("before",) + PHASES:
        row, want = out.get(phase), ref.get(phase)
        if row is None or want is None:
            continue
        delta = abs(row["cc_sulc"] - want["cc_sulc"])
        ratio = (row["areal_mean"] / want["areal_mean"]
                 if want["areal_mean"] else float("nan"))
        note = ""
        if phase == "msmpair":
            note = (" (pattern only: the JAX row ran the reference's own "
                    "config file, which is not in the repository)")
        elif phase != "before" and same and out.get("it") is None \
                and delta > CC_BAND:
            note = f" OUTSIDE the {CC_BAND} band: a fault to record"
        lines.append(
            f"{phase}: cc_sulc port {row['cc_sulc']:.4f} JAX "
            f"{want['cc_sulc']:.4f} |delta| {delta:.4f}; areal_mean port "
            f"{row['areal_mean']:.4f} JAX {want['areal_mean']:.4f} ratio "
            f"{ratio:.3f}{note}")
    return lines


def report(out: dict) -> int:
    """Print the comparison with the JAX package's recorded rows
    (parity_fast.json for a --fast result, else parity_full.json, at the
    repository root) and the gates; the exit code."""
    ref = None
    reference = os.path.join(ROOT, "parity_fast.json" if out["fast"]
                             else "parity_full.json")
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
    ap.add_argument("--subjects", type=int, default=6)
    ap.add_argument("--res", type=int, default=6)
    ap.add_argument("--fast", action="store_true",
                    help="the harness's FAST_* configs")
    ap.add_argument("--it", type=int, default=None,
                    help="iterations of every level of every config")
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--group-ranks", type=int, default=1)
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    ap.add_argument("--metrics", default=None,
                    help="the groupwise driver's JSONL events (printed)")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..core.mesh import Mesh
    from ..eval.synth import synth_cohort
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
    if args.metrics:
        open(args.metrics, "w").close()      # the driver appends
    meshes, datasets, template_data = synth_cohort(args.res, args.subjects,
                                                   seed=0)
    template = Mesh.from_icosphere(args.res)
    template.true_rescale(100.0)
    print(f"cohort: synth_cohort({args.res}, {args.subjects}, seed=0); "
          f"phases {phases}; {'FAST_* configs' if args.fast else 'configs'}"
          f"; iterations {args.it or 'as configured'}", flush=True)
    before = channel_stats(datasets)
    before.update(areal_mean=0.0, areal_max=0.0, areal_95=0.0, areal_98=0.0,
                  shape_mean=0.0, shape_max=0.0)      # identity warp
    out = {"fast": args.fast, "S": args.subjects, "res": args.res,
           "it": args.it, "device": str(device), "before": before}
    for phase in phases:
        cfg = config(phase, args.fast, args.it)
        print(f"{phase}:", flush=True)
        t0 = time.perf_counter()
        if phase == "groupwise":
            row = run_groupwise(meshes, datasets, template, cfg, device,
                                args.group_ranks, args.metrics)
            row["ranks"] = args.group_ranks
            if args.metrics:
                print_group_metrics(args.metrics)
        else:
            row = run_pairwise(meshes, datasets, template_data, cfg, device)
        row["wall_s"] = time.perf_counter() - t0
        out[phase] = row
        print(f"{phase}: {json.dumps(row)}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return report(out)


if __name__ == "__main__":
    sys.exit(main())
