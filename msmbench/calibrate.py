#!/usr/bin/env python3
"""Readings for the limits of `correct` (not part of a benchmark run).

    python3 msmbench/calibrate.py --workload CELL --seed N \
        --passes sound,perturb=1,bf16_costs,half_alphas,pool=7 [--out FILE]

In one process on the card (the cell's warm-up once, before the first
pass), each pass runs every window unit of the cell's pool through the
cell's entry and prints one JSON line (appended to --out too) with the
judge's numbers for what it produced:

- sound: the program as it is; the line also holds the control's numbers
  (the reference one precision lower put in the program's place), and its
  `info.subjects` are the scores a limits file's "subjects" bands take;
- perturb=K: the program on its inputs times 1 + 1e-6 N(0,1), the noise
  drawn from K (faults.perturb): what a change of rounding inside the
  program can move;
- a fault of msmbench/faults.py (bf16_costs, half_alphas, half_subjects,
  no_regrow): the upper readings of the optimiser's numbers;
- pool=P: the program on another pool of subjects (the traffic's pool_seed
  replaced by P), for the numbers that do not need a band; with the
  control's numbers on that pool too.
"""
from __future__ import annotations

import argparse
import copy
import json
import pathlib
import shutil
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from msmbench import faults, harness  # noqa: E402


def run_pass(cell, name: str, seed: int, device, warm: bool) -> dict:
    """One pass (see the module's doc); returns its JSON row."""
    if name.startswith("pool="):
        cell = copy.copy(cell)
        cell.traffic = dict(cell.traffic, pool_seed=int(name[5:]))
    workdir = tempfile.mkdtemp(prefix="msmbench-cal-")
    entry = harness.load_module(cell.entry_path, cell.traffic["entry"]).Entry(
        cell, seed, device, workdir, False)
    entry.warm_up = warm    # the pool stays the traffic's either way
    remove = None
    try:
        entry.setup()
        if name.startswith("perturb="):
            faults.perturb(entry.inputs.data, int(name[8:]))
        elif name in faults.FAULTS:
            remove = faults.install(name)
        walls = []
        for i in range(entry.capacity()):
            t0 = time.perf_counter()
            entry.run_unit(i)
            walls.append(time.perf_counter() - t0)
        if remove is not None:
            remove()
            remove = None
        entry.release()
        row = {"workload": cell.name, "pass": name, "seed": seed,
               "walls": walls,
               "failed": sum(u["failed"] for u in entry.units),
               "program": entry.judge()}
        if name == "sound" or name.startswith("pool="):
            row["control"] = entry.judge(control=True)
    finally:
        if remove is not None:
            remove()
        entry.close()
        shutil.rmtree(workdir, ignore_errors=True)
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--passes", required=True)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell(harness.load_json(ROOT / "BENCHMARK.json"),
                        args.workload)
    for k, name in enumerate(args.passes.split(",")):
        row = run_pass(cell, name, args.seed, torch.device("cuda"), k == 0)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
