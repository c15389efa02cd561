"""Spans, marks and counters of one registration, on the profiler's clock:
the drivers' `--metrics` JSONL.

Tracing is on exactly while a run opened with a metrics path is active
(the CLI's --metrics, a driver's `metrics_path`, run_gmsm(metrics_path=)):
`run(path, device)` binds a Tracer in a context variable for that run,
and code anywhere below it calls this module's functions, which find the
tracer there.

- `span(name)`: a stage. It syncs the device at both ends, so its wall is
  device work finished, enters a profiler range `name` and, when it ends,
  writes one line {"event": "span", "name", "id", "parent",
  "unit", "t0_ns", "t1_ns", "wall_s", "wait_s", "counters"}. The stamps are
  `time.time_ns()`, the base of the profiler's event starts; `unit` is one
  id per run (a registration, or a cohort with its post-processing);
  `wait_s` is the host seconds blocked on the device inside the span (its
  `read` calls and closing sync, its children's included).
- `mark(name)`: a fine-grained step (a fusion move, an AFFINE step). A
  profiler range that never syncs and writes no line: its count and host
  seconds go to the enclosing span's counters[name] {"n", "s"}.
- `count(name, n)`: adds n to the enclosing span's counters[name].
- `read(x)`: `x.item()` of a 0-d tensor, else `x.cpu()`, timed as a wait.
- `event(name, **fields)`: one {"event": name, ...} line.
- `cached(maxsize)`: a memo like functools.lru_cache for the host-table
  builders; each call is a `host_tables` hit or miss in the enclosing
  span's counters {"hit", "miss", "s"} (s: host seconds of the outermost
  misses), and a miss is a `host_tables` range.

The ranges are record functions of the host-op kind
(`torch._C._profiler._RecordFunctionFast`), so that a profiler's host
timeline holds them by name; `torch.profiler.record_function` would make
them user annotations, which the profiler also lays over the device
timeline as intervals of device activity. A range is entered only while a
profiler runs (such a range may not end while one runs if it began
without one); a profiler started inside an open span, as the benchmark
starts one at the last level, gets that span's range at the next range
entered.

Lines are kept in memory and written to the path once, when the run that
opened the tracer ends (also on an error). With no tracer bound every
function returns at once: `span` and `mark` give one shared no-op object,
`read` is the plain `.item()` / `.cpu()`; no sync, no profiler range, no
clock read.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import itertools
import json
import os
import time
from typing import Optional

import torch

_TRACER = contextvars.ContextVar("newmsm_tpu_torch_tracer", default=None)
_UNITS = itertools.count()


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


def _range(name: str):
    """An entered profiler range of the host-op kind, or None when no
    profiler runs."""
    if not _profiling():
        return None
    rng = torch._C._profiler._RecordFunctionFast(name)
    rng.__enter__()
    return rng


def _end(rng, exc) -> None:
    if rng is not None:
        rng.__exit__(*exc)


class _Off:
    """What `span` and `mark` give while tracing is off."""
    __slots__ = ()
    wall_s = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class Span:
    __slots__ = ("tracer", "name", "id", "parent", "t0", "wait", "counters",
                 "wall_s", "live", "_ranges")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name
        self.wait, self.wall_s, self.counters = 0.0, 0.0, {}

    def __enter__(self):
        tr = self.tracer
        tr.sync()
        self.id = next(tr._ids)
        self.parent = tr._stack[-1].id if tr._stack else None
        self.t0 = time.time_ns()
        tr.ranges_live()
        rng = _range(self.name)
        self.live = rng is not None
        self._ranges = [rng]
        tr._stack.append(self)
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        tr.sync()
        t1 = time.time_ns()
        for rng in reversed(self._ranges):
            _end(rng, exc)
        tr._stack.pop()
        self.wall_s = (t1 - self.t0) * 1e-9
        if tr._stack:
            tr._stack[-1].wait += self.wait
        tr._emit({"event": "span", "name": self.name, "id": self.id,
                  "parent": self.parent, "unit": tr.unit, "t0_ns": self.t0,
                  "t1_ns": t1, "wall_s": round(self.wall_s, 6),
                  "wait_s": round(self.wait, 6),
                  "counters": _rounded(self.counters)})
        return False


class Mark:
    __slots__ = ("tracer", "name", "t", "_range")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        self.tracer.ranges_live()
        self._range = _range(self.name)
        self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t
        _end(self._range, exc)
        c = self.tracer.counters(self.name, {"n": 0, "s": 0.0})
        if c is not None:
            c["n"] += 1
            c["s"] += dt
        return False


def _rounded(counters: dict) -> dict:
    return {k: ({kk: round(vv, 6) if isinstance(vv, float) else vv
                 for kk, vv in v.items()} if isinstance(v, dict) else v)
            for k, v in counters.items()}


class Tracer:
    """The spans, marks and events of one run; lines go to `path` (None:
    kept nowhere, as on the ranks that do not write)."""

    def __init__(self, path: Optional[str], device):
        self.path = path
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.unit = f"{os.getpid()}-{next(_UNITS)}"
        self._ids = itertools.count()
        self._stack: list = []
        self._lines: list = []
        self._table_depth = 0

    def ranges_live(self) -> None:
        """When a profiler runs, give the open spans it has not seen (it
        started inside them) a range each, outermost first."""
        if self._stack and not self._stack[-1].live and _profiling():
            for span in self._stack:
                if not span.live:
                    span._ranges.append(_range(span.name))
                    span.live = True

    def _emit(self, line: dict):
        self._lines.append(json.dumps(line))

    def flush(self):
        if self.path and self._lines:
            with open(self.path, "a") as f:
                f.write("\n".join(self._lines) + "\n")
        self._lines = []

    def sync(self):
        """Wait for the device's queued work; the wait goes to the span
        open at the time."""
        if self.cuda and torch.cuda.is_initialized():
            t = time.perf_counter()
            torch.cuda.synchronize(self.device)
            self.waited(time.perf_counter() - t)

    def waited(self, seconds: float):
        if self._stack:
            self._stack[-1].wait += seconds

    def counters(self, name: str, empty):
        """The enclosing span's counter `name` (set to `empty` first), or
        None outside every span."""
        if not self._stack:
            return None
        return self._stack[-1].counters.setdefault(name, empty)


def active() -> bool:
    return _TRACER.get() is not None


@contextlib.contextmanager
def run(path: Optional[str], device, on: Optional[bool] = None):
    """Tracing for one run, on when `on` (default: a path is given). A run
    inside another one of the same path adopts its tracer (the CLI's, a
    pipeline's), so their spans share a unit and one write; otherwise it
    gets its own tracer, written when it ends, or none when off. Yields
    the tracer or None."""
    on = bool(path) if on is None else on
    outer = _TRACER.get()
    if on and outer is not None and outer.path == path:
        yield outer
        return
    tracer = Tracer(path, device) if on else None
    token = _TRACER.set(tracer)
    try:
        yield tracer
    finally:
        _TRACER.reset(token)
        if tracer is not None:
            tracer.flush()


def span(name: str):
    tr = _TRACER.get()
    return OFF if tr is None else Span(tr, name)


def mark(name: str):
    tr = _TRACER.get()
    return OFF if tr is None else Mark(tr, name)


def count(name: str, n: int = 1) -> None:
    tr = _TRACER.get()
    if tr is not None and tr._stack:
        c = tr._stack[-1].counters
        c[name] = c.get(name, 0) + n


def event(name: str, **fields) -> None:
    tr = _TRACER.get()
    if tr is not None:
        tr._emit({"event": name, **fields})


def read(x: torch.Tensor):
    """x.item() of a 0-d tensor, else x.cpu(): a read of device results by
    the host, timed as a wait of the enclosing span when tracing."""
    tr = _TRACER.get()
    if tr is None:
        return x.item() if x.dim() == 0 else x.cpu()
    t = time.perf_counter()
    out = x.item() if x.dim() == 0 else x.cpu()
    tr.waited(time.perf_counter() - t)
    return out


def table_hit() -> None:
    """A host table found in its cache."""
    tr = _TRACER.get()
    if tr is not None:
        c = tr.counters("host_tables", {"hit": 0, "miss": 0, "s": 0.0})
        if c is not None:
            c["hit"] += 1


class _TableMiss:
    __slots__ = ("tracer", "t", "_range")

    def __init__(self, tracer: Tracer):
        self.tracer = tracer

    def __enter__(self):
        self.tracer.ranges_live()
        self._range = _range("host_tables")
        self.tracer._table_depth += 1
        self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t
        tr = self.tracer
        tr._table_depth -= 1
        _end(self._range, exc)
        c = tr.counters("host_tables", {"hit": 0, "miss": 0, "s": 0.0})
        if c is not None:
            c["miss"] += 1
            if tr._table_depth == 0:     # builders nested in it: counted once
                c["s"] += dt
        return False


def table_miss():
    """A host table built because its cache lacked it (a context)."""
    tr = _TRACER.get()
    return OFF if tr is None else _TableMiss(tr)


def cached(maxsize: Optional[int] = None):
    """functools.lru_cache(maxsize) for a host-table builder, reporting
    each call as a `host_tables` hit or miss."""
    def wrap(fn):
        store: collections.OrderedDict = collections.OrderedDict()

        @functools.wraps(fn)
        def call(*args, **kw):
            key = (args, tuple(sorted(kw.items()))) if kw else args
            if key in store:
                table_hit()
                if maxsize is not None:
                    store.move_to_end(key)
                return store[key]
            with table_miss():
                out = fn(*args, **kw)
            store[key] = out
            if maxsize is not None and len(store) > maxsize:
                store.popitem(last=False)
            return out
        call.cache_clear = store.clear
        return call
    return wrap
