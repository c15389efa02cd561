#!/usr/bin/env python3
"""The benchmark of newmsm_tpu_torch (the PyTorch / CUDA port) on one
NVIDIA H100.

    python3 msmbench/run.py --workload CELL --seed N --seconds S --trace 0|1

run from the root of a checkout. One process a run:

  1. set-up: imports, the CUDA context, the kernel library (built by the
     program's ops/_build.py into build/newmsm_tpu_torch/ inside the
     checkout on a checkout's first run, loaded from there afterwards),
     the inputs made from --seed by the frozen generator (msmbench/synth.py)
     and the warm-up the cell's traffic mix names;
  2. the window: whole units (one subject's or one cohort's
     registration); another starts only while the time left is at least
     the mean unit time so far, and the first always runs. With --trace 1
     the program writes its metrics events in every unit, and after the
     window one more unit runs with the last level of its registration
     under torch.profiler (reduced in memory: device busy and idle, K1's
     kernel time against the work of its calls, the breakdown);
  3. the judge: the plain reference (msmbench/reference/) works out again
     what the units produced and compares it value by value; each number
     is printed beside its limit (standard error, and the result line's
     last key, `checks`);
  4. one JSON line on standard output: correct, attempted, failed,
     metrics (the cell's end-to-end metrics with --trace 0, its per-layer
     metrics with --trace 1), device (and with --trace 1 breakdown).

The cells (BENCHMARK.json `workloads`, all on one chip): strain_warm and
gmsm_s8. Everything a cell is made of is found by
name: configs/<config>.json, traffic/<mix>.json, entries/<entry>.py,
end_to_end/<metric>.py, layers/<metric>.py, limits/<cell>.json; a new
cell or metric is new files and new entries in BENCHMARK.json.

What a run writes: its outputs under a fresh directory in $TMPDIR
(removed at the end), the kernel library and its compiler log under
build/newmsm_tpu_torch/ and the CUDA JIT cache under build/cuda_cache/,
both inside the checkout (reused by every later run there).

The process and the CLI cell's subprocesses run with HOST_THREADS host
threads (OpenMP, BLAS and torch's own pool), so that the host work, which
paces these launch-bound registrations, does not spread its runs over
threads that contend with each other.

Exits non-zero, with no result line, without a CUDA card (or with fewer
than the cell's chips), when a module of JAX or of the JAX package
(top-level names jax, jaxlib, flax, newmsm_tpu, compared whole) is loaded
once the window has closed, and when a traced run finds nothing to read
for one of the cell's per-layer metrics (a span, a hook or the K1 kernel's
name the program no longer has).
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")
HOST_THREADS = 4
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(HOST_THREADS)

from msmbench import harness  # noqa: E402
from msmbench.reference import judge  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def layer_context(entry, window, trace_summary, k1_calls, peak) -> dict:
    """What a per-layer reader reads: per unit its subjects, wall seconds
    and the program's metrics events; the trace's reduction; K1's calls
    inside the traced span; the peak device memory."""
    events = entry.layer_events()
    units = [{"subjects": u["subjects"], "wall_s": w, "events": ev}
             for u, w, ev in zip(entry.units, window.walls, events)]
    return {"units": units, "trace": trace_summary, "k1_calls": k1_calls,
            "peak_bytes": peak}


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float = T0, workdir_root=None):
    """One run of `cell`; returns (result dict, check lines). The caller
    has made sure of the device."""
    import torch
    workdir = tempfile.mkdtemp(prefix="msmbench-", dir=workdir_root)
    entry = harness.load_module(cell.entry_path, cell.traffic["entry"]) \
        .Entry(cell, seed, device, workdir, trace)
    try:
        entry.setup()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t0

        window = harness.Window(seconds)
        window.open()
        attempted = failed = 0
        i = 0
        while window.more() and i < entry.capacity():
            unit = entry.run_unit(i)
            window.close_unit()
            attempted += unit["subjects"]
            failed += unit["failed"]
            i += 1
        peak = entry.peak_bytes()
        summary, k1_calls = None, []
        if trace:
            k1 = harness.K1Recorder()
            k1.install()
            try:
                summary, k1_calls = entry.profile_unit(
                    i, harness.DeviceTrace(k1))
            finally:
                k1.uninstall()

        run = {"window": window, "setup_s": setup_s,
               "completed": attempted - failed}
        if not trace:
            metrics = {}
            for m in cell.end_to_end:
                read = harness.load_module(
                    harness.HERE / "end_to_end" / f"{m['name']}.py",
                    m["name"]).read
                metrics[m["name"]] = {"value": read(run), "unit": m["unit"]}
        else:
            ctx = layer_context(entry, window, summary, k1_calls,
                                peak or None)
            metrics = {}
            for m in cell.per_layer:
                read = harness.load_module(
                    harness.HERE / "layers" / f"{m['name']}.py",
                    m["name"]).read
                value = read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}

        entry.release()
        numbers = entry.judge()
        ok, checks = judge.checks(numbers, cell.limits)
        info = numbers.get("info", {})
        errors = [u["error"] for u in entry.units if u.get("error")]
    finally:
        entry.close()
        shutil.rmtree(workdir, ignore_errors=True)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": cell.spec["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok and failed == 0), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {
            key: [[name[:160], sec] for name, sec in summary[key]]
            for key in ("device_ops", "idle_gaps")}
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in checks.items()}
    lines = [f"unit errors: {e}" for e in errors]
    lines.append(f"units {len(window.walls)}, walls "
                 f"{[round(w, 4) for w in window.walls]} s, setup "
                 f"{setup_s:.4f} s; reference info {json.dumps(info)}")
    for name, c in checks.items():
        sign = "<=" if c["kind"] == "max" else ">="
        lines.append(f"check {name}: {c['value']!r} {sign} {c['limit']!r} "
                     f"{'ok' if c['ok'] else 'FAILED'}")
    return result, lines


def silent_metrics(cell, result: dict, trace: bool) -> list:
    """The cell's per-layer metrics that a traced run's line lacks: their
    readers found nothing to read."""
    if not trace:
        return []
    return [m["name"] for m in cell.per_layer
            if m["name"] not in result["metrics"]]


def main(argv=None) -> int:
    args = parse(argv)
    cell = harness.Cell(harness.load_json(ROOT / "BENCHMARK.json"),
                        args.workload)
    import torch
    torch.set_num_threads(HOST_THREADS)
    chips = cell.spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"msmbench: cell {cell.name} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda"))
    bad = harness.forbidden_modules()
    if bad:
        print(f"msmbench: modules of JAX or the JAX package are loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    silent = silent_metrics(cell, result, bool(args.trace))
    if silent:
        print(f"msmbench: the traced run found nothing to read for "
              f"{silent}", file=sys.stderr)
        return 4
    print(harness.power_limit(), file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
