"""The general parts of the benchmark: finding a cell's pieces by name,
the measured window, the profiler span and its reduction, the K1 work
recorder, and the result line.

Nothing here knows a configuration, a traffic mix or a metric by name:
BENCHMARK.json names them, and each lives in a file of its own under
msmbench/ (configs/, traffic/, entries/, layers/, limits/).
"""
from __future__ import annotations

import bisect
import importlib.util
import json
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "newmsm_tpu")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path, name: str):
    """Import a benchmark file by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "msmbench_piece_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of BENCHMARK.json with its pieces: the configuration,
    the traffic mix, the entry module, the limits, and the metrics it
    reports (end-to-end with --trace 0, per-layer with --trace 1)."""

    def __init__(self, bench: dict, name: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                             f"{sorted(cells)}")
        self.spec = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_spec = configs[self.spec["config"]]
        self.config = load_json(ROOT / self.config_spec["file"])
        self.traffic = load_json(
            HERE / "traffic" / f"{self.spec['traffic']}.json")
        self.entry_path = HERE / "entries" / f"{self.traffic['entry']}.py"
        limits = load_json(HERE / "limits" / f"{name}.json")
        self.limits = limits["limits"]
        # per subject of the traffic's pool, what its registration reads
        # in sound runs (judge.py: cc_drop, warp_rise)
        self.bands = limits.get("subjects", {})
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if self._reports(
            m, bench)]

    def _reports(self, metric: dict, bench: dict) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        moved = next(m for m in bench["end_to_end"]
                     if m["name"] == metric["moves"])
        return self.name in moved.get("workloads", [self.name])

    def config_text(self) -> str:
        """The configuration file as the program reads it: one `--key=value`
        line per option (`--key` alone for a flag set to true)."""
        lines = []
        for key, value in self.config["options"].items():
            if value is True:
                lines.append(f"--{key}")
            else:
                lines.append(f"--{key}={value}")
        return "\n".join(lines) + "\n"


class Window:
    """The measured window, in whole units: another unit starts only while
    the time left is at least the mean unit time so far, and the first
    always runs. Times a subject are taken from the start to the end of
    the last unit, over the subjects it completed."""

    def __init__(self, seconds: float, clock=time.perf_counter):
        self.seconds = float(seconds)
        self.clock = clock
        self.start = None
        self.ends: list = []
        self.walls: list = []

    def open(self):
        self.start = self.clock()

    def more(self) -> bool:
        if not self.ends:
            return True
        elapsed = self.ends[-1] - self.start
        left = self.seconds - elapsed
        return left >= elapsed / len(self.ends)

    def close_unit(self) -> float:
        """Mark a unit's end; returns its wall seconds."""
        end = self.clock()
        wall = end - (self.ends[-1] if self.ends else self.start)
        self.ends.append(end)
        self.walls.append(wall)
        return wall

    @property
    def elapsed(self) -> float:
        return self.ends[-1] - self.start

    def seconds_per_subject(self, completed: int) -> float:
        return self.elapsed / max(completed, 1)


def union_seconds(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals."""
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def idle_gaps(intervals, start: float, stop: float):
    """The gaps (start, end) in [start, stop] that no interval covers."""
    gaps, end = [], start
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if stop > end:
        gaps.append((end, stop))
    return gaps


class K1Recorder:
    """Records the arguments of every call of the program's locate kernel
    wrapper (`ops.locate.locate_bary`) while `on`: (queries, res). The
    wrapper is put around the program's function from outside; callers
    reach it through the module attribute, so all of them are seen."""

    def __init__(self):
        self.calls: list = []
        self.on = False
        self._orig = None

    def install(self):
        from newmsm_tpu_torch.ops import locate
        self._orig = locate.locate_bary
        orig, rec = self._orig, self

        def recorded(px, py, pz, res):
            if rec.on and px.device.type == "cuda":
                rec.calls.append((int(px.numel()), int(res)))
            return orig(px, py, pz, res)
        locate.locate_bary = recorded

    def uninstall(self):
        if self._orig is not None:
            from newmsm_tpu_torch.ops import locate
            locate.locate_bary = self._orig
            self._orig = None


class DeviceTrace:
    """A torch.profiler span (host ops and device activity), reduced in
    memory once stopped: device busy seconds (union of the intervals of
    every device activity), the span's length, K1's kernel seconds, the
    device operations that took most time, and the longest idle gaps by the
    innermost host op running at their middle (or, where the host runs
    Python between ops, the op it last finished)."""

    K1_KERNEL = "locate_bary_kernel"

    def __init__(self, k1: K1Recorder | None = None):
        self.k1 = k1
        self.prof = None
        self.summary = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        if self.prof is not None or self.summary is not None:
            return
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        if self.k1 is not None:
            self.k1.on = True

    def stop(self):
        import torch
        if self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        if self.k1 is not None:
            self.k1.on = False
        t0 = time.perf_counter()
        events = self.prof.profiler.kineto_results.events()
        self.summary = reduce_events(
            (e.name(), str(e.device_type()), e.start_ns() * 1e-9,
             e.duration_ns() * 1e-9) for e in events)
        self.summary["reduce_s"] = time.perf_counter() - t0
        self.prof = None


def reduce_events(events) -> dict:
    """events: (name, device type, start s, duration s). Device events are
    those whose type names CUDA."""
    dev, host, k1 = [], [], 0.0
    by_name: dict = {}
    for name, dtype, start, dur in events:
        if "CUDA" in dtype:
            dev.append((start, start + dur))
            by_name[name] = by_name.get(name, 0.0) + dur
            if DeviceTrace.K1_KERNEL in name:
                k1 += dur
        else:
            host.append((start, start + dur, name))
    stamps = [a for a, _ in dev] + [a for a, _, _ in host]
    ends = [b for _, b in dev] + [b for _, b, _ in host]
    if not stamps:
        return {"busy_s": 0.0, "window_s": 0.0, "k1_kernel_s": 0.0,
                "n_events": 0, "device_ops": [], "idle_gaps": []}
    lo, hi = min(stamps), max(ends)
    gaps = sorted(idle_gaps(dev, lo, hi), key=lambda g: g[0] - g[1])[:10]
    host.sort(key=lambda h: h[1])
    host_ends = [e for _, e, _ in host]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        inner = [(s, e, n) for s, e, n in host if s <= mid <= e]
        if inner:
            label = min(inner, key=lambda h: h[1] - h[0])[2]
        else:       # host code outside any op: name the op it came from
            k = bisect.bisect_right(host_ends, mid) - 1
            label = f"after {host[k][2]}" if k >= 0 else "host, no op"
        named.append([label, b - a])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": union_seconds(dev), "window_s": hi - lo,
            "k1_kernel_s": k1, "n_events": len(dev) + len(host),
            "device_ops": [[n, s] for n, s in top], "idle_gaps": named}


def level_trace(cls, trace: DeviceTrace, last_level_of):
    """Put `trace` around the last level of the next run of a driver class
    (the program's MeshRegistration or GroupMeshRegistration): it starts
    when `_initialize_level` is called for that level and stops when
    `_write_outputs` begins. Returns a function that takes the hooks off."""
    init, write = cls._initialize_level, cls._write_outputs

    def traced_init(self, level, *a, **k):
        if level == last_level_of(self) and trace.summary is None:
            trace.start()
        return init(self, level, *a, **k)

    def traced_write(self, *a, **k):
        trace.stop()
        return write(self, *a, **k)

    cls._initialize_level, cls._write_outputs = traced_init, traced_write

    def remove():
        cls._initialize_level, cls._write_outputs = init, write
    return remove


def driver_metrics(cls, path_fn):
    """Turn on the program's per-event JSONL (`metrics_path`, the file
    `path_fn()` names) for every instance of a driver class built from now
    on, as the CLI's --metrics does. Returns a function that takes the hook
    off."""
    init = cls.__init__

    def with_metrics(self, *a, **k):
        init(self, *a, **k)
        self.metrics_path = path_fn()

    cls.__init__ = with_metrics

    def remove():
        cls.__init__ = init
    return remove


def read_jsonl(path) -> list:
    p = pathlib.Path(path)
    if not p.exists():
        return []
    return [json.loads(line) for line in p.read_text().splitlines() if line]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one the
    benchmark's process must not hold, compared whole."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def power_limit() -> str:
    """nvidia-smi's name and power limit of the card the run uses (found by
    its UUID, whatever CUDA_VISIBLE_DEVICES maps), or '' if it cannot be
    read."""
    try:
        import torch
        uuid = str(torch.cuda.get_device_properties(
            torch.device("cuda")).uuid)
        uuid = uuid if uuid.startswith("GPU-") else "GPU-" + uuid
        proc = subprocess.run(
            ["nvidia-smi", "-i", uuid, "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return proc.stdout.strip()
    except (OSError, RuntimeError, AttributeError,
            subprocess.TimeoutExpired):
        return ""
