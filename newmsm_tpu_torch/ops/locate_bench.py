"""Timing of the locate kernel on the card, and the yardsticks beside it.

    python -m newmsm_tpu_torch.ops.locate_bench [--res 6] [--queries 983808]
        [--source OTHER.cu ...] [--order 0,1,1,0]

times the package's kernel (source 0) and, in turns inside one process on
one card, any other source with the same C interface (source 1, 2, ...: an
earlier version of the kernel, to compare two versions under one clock and
power state). chip_smoke.py uses `time_launches` and `ClockSampler` for
its timing phase.

A time is one CUDA-event pair around `launches` back-to-back launches into
preallocated outputs, divided by `launches`; `windows` such windows make a
round; rounds repeat until nvidia-smi has been sampled a few times under
the load, and the last round is reported (median and spread), so the clock
ramp of an idle card is not in the number. With `hold_cycles` a window's
first event waits behind a device-side sleep of that many clocks, while
the host queues the window's launches: a launch that costs the host more
than the card is then timed on the card, not at the host's rate. Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import threading
import time

import torch

from . import _build, locate

# NVIDIA H100 SXM data sheet: dense FP32 rate outside the tensor cores,
# HBM3 rate, SMs x FP32 lanes (= thread-instructions issued per clock)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
ISSUE_LANES_PER_SM = 128
BYTES_PER_QUERY = 28          # 3 f32 in; 1 i32 + 3 f32 out


def flops_per_query(res: int) -> int:
    """Floating-point operations the kernel's algorithm needs for one query
    (add, multiply, min, compare, divide, sqrt and rsqrt count 1, a fused
    multiply-add 2; selects and integer work count 0):
      normalise 9; base scan 20 x (3 dots x 5 + 2 min + 1 compare) = 360;
      chosen face's 3 carried dots 15 and orientation sign 18;
      per level 3 midpoints x 12 + 3 cross products x 9 + 3 plane
      distances x 12 + 8 min + 3 compare = 110;
      weights: normal 15, projection 14, 3 areas x 22, total 2, 3
      divisions = 100."""
    return 9 + 360 + (15 + 18 if res > 0 else 0) + 110 * res + 100


def roofline(res: int, n_queries: int) -> dict:
    """Least time the card could take for `n_queries` at level `res`:
    the larger of bytes over the memory rate and flops over the FP32 rate."""
    t_bytes = n_queries * BYTES_PER_QUERY / PEAK_BYTES_PER_S
    t_flops = n_queries * flops_per_query(res) / PEAK_FP32_FLOPS
    return {"bound_ms": 1e3 * max(t_bytes, t_flops),
            "bound_by": "operations" if t_flops >= t_bytes else "bytes",
            "bytes_ms": 1e3 * t_bytes, "operations_ms": 1e3 * t_flops}


class ClockSampler:
    """Samples `nvidia-smi --query-gpu=clocks.sm,power.draw` in a thread
    while the block runs; `.samples` is a list of (MHz, W)."""

    def __init__(self, index: int = 0):
        self.samples: list = []
        self._index = str(index)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            proc = subprocess.run(
                ["nvidia-smi", "-i", self._index,
                 "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=60)
            try:
                mhz, watt = (float(x) for x in proc.stdout.strip().split(","))
                self.samples.append((mhz, watt))
            except ValueError:
                pass
            self._stop.wait(0.02)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def time_launches(launch_once, windows: int = 5, launches: int = 200,
                  warmup: int = 50, load_samples: int = 3,
                  max_seconds: float = 6.0, hold_cycles: int = 0) -> dict:
    """Per-launch milliseconds of `launch_once()` on the current device:
    see the module docstring. Returns ms (median of the last round),
    ms_min, ms_max, ms_spread ((max-min)/median), windows_ms, rounds and
    the (MHz, W) samples taken while the rounds ran."""
    for _ in range(warmup):
        launch_once()
    torch.cuda.synchronize()
    rounds = 0
    t0 = time.perf_counter()
    with ClockSampler(torch.cuda.current_device()) as sampler:
        while True:
            per = []
            for _ in range(windows):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                if hold_cycles:
                    torch.cuda._sleep(hold_cycles)
                a.record()
                for _ in range(launches):
                    launch_once()
                b.record()
                b.synchronize()
                per.append(a.elapsed_time(b) / launches)
            rounds += 1
            if (len(sampler.samples) >= load_samples
                    or time.perf_counter() - t0 > max_seconds):
                break
    med = statistics.median(per)
    return {"ms": med, "ms_min": min(per), "ms_max": max(per),
            "ms_spread": (max(per) - min(per)) / med, "windows_ms": per,
            "launches_per_window": launches, "rounds": rounds,
            "clock_samples_mhz_w": sampler.samples}


def issue_slot_ms(instructions: int, n_queries: int, sm_count: int,
                  sm_mhz: float) -> float:
    """Least time to ISSUE the kernel's instructions: every query runs
    `instructions` (the straight-line SASS of one thread), and an SM issues
    ISSUE_LANES_PER_SM thread-instructions per clock."""
    return 1e3 * n_queries * instructions / (
        sm_count * ISSUE_LANES_PER_SM * sm_mhz * 1e6)


def random_queries(n_queries: int, device):
    """Seeded random query components (px, py, pz) on `device`."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn((n_queries, 3), generator=g).to(device)
    return tuple(q[:, i].contiguous() for i in range(3))


def bench_source(source, res: int, n_queries: int,
                 flags=_build.NVCC_FLAGS) -> dict:
    """Build `source` (a name under csrc/ or a path to a .cu with the
    kernel's C interface) with `flags` and time it at (res, n_queries)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    lib = locate.SEAM.declare(_build.load(source, flags, mark="k1.load"))
    tables = locate.kernel_tables(dev)
    if hasattr(lib, "locate_bary_set_tables"):   # each build has its copy
        locate.set_constant_tables(lib, dev)
    px, py, pz = random_queries(n_queries, dev)
    fid = torch.empty(n_queries, dtype=torch.int32, device=dev)
    w0, w1, w2 = (torch.empty_like(px) for _ in range(3))
    out = time_launches(lambda: locate.launch(px, py, pz, res, tables, fid,
                                              w0, w1, w2, lib=lib))
    out["source"] = str(source)
    out.update(static_profile(source, res, n_queries, out, flags))
    return out


def static_profile(source, res: int, n_queries: int, timed: dict,
                   flags=_build.NVCC_FLAGS) -> dict:
    """What the compiler made of the level-`res` kernel of `source`: the
    ptxas resource line, the SASS instruction count and, for a kernel
    templated on the level (straight-line code: static count = executed
    count), the issue-slot bound at the median SM clock sampled in `timed`."""
    name = f"{locate.KERNEL}ILi{res}E"
    templated = name in _build.compiler_log(source, flags)
    if not templated:
        name = locate.KERNEL
    opcodes = _build.sass_opcodes(source, name, flags)
    out = {"ptxas": _build.ptxas_usage(source, name, flags),
           "sass_instructions": sum(opcodes.values()),
           "sass_opcodes": dict(opcodes.most_common()),
           "issue_slot_ms": None, "sm_mhz": None}
    clocks = [mhz for mhz, _ in timed["clock_samples_mhz_w"]]
    if clocks:
        out["sm_mhz"] = statistics.median(clocks)
    if templated and clocks:
        sms = torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count
        out["issue_slot_ms"] = issue_slot_ms(out["sass_instructions"],
                                             n_queries, sms, out["sm_mhz"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=6)
    ap.add_argument("--queries", type=int, default=983808,
                    help="2,562 control points x 4 labels x 96 patch slots")
    ap.add_argument("--source", action="append", default=[],
                    help="another .cu with the same C interface")
    ap.add_argument("--other-flags", default="",
                    help="nvcc flags of the other sources, space separated "
                         "(default: the package's)")
    ap.add_argument("--order", default="",
                    help="turns, e.g. 1,0,0,1 (0 is the package's kernel)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("locate_bench: CUDA is not available")
    sources = [locate.SOURCE, *args.source]
    order = ([int(x) for x in args.order.split(",")] if args.order
             else list(range(len(sources))))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    print(json.dumps({"res": args.res, "queries": args.queries,
                      **roofline(args.res, args.queries)}))
    other = tuple(args.other_flags.split()) or _build.NVCC_FLAGS
    for turn in order:
        r = bench_source(sources[turn], args.res, args.queries,
                         _build.NVCC_FLAGS if turn == 0 else other)
        print(json.dumps({"turn": turn, **r}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
