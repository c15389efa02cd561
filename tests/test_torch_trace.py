"""The port's tracer (newmsm_tpu_torch/trace.py) on the CPU, at ico-3: off
it costs no sync, no profiler range and no file; on, its span lines form
one tree a unit, on the profiler's clock, beside every event the drivers
wrote before it; the benchmark's span readers (msmbench/layers/) read
them. The traced units are the benchmark's tiny cells
(msmbench/tests/msmbench_tiny.py): a warm pairwise subject, a 4-subject
cohort and a fresh CLI process."""
from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch

from newmsm_tpu_torch import trace
from newmsm_tpu_torch.eval import metrics as em

CPU = torch.device("cpu")
SEED = 2 ** 33 + 5

# the event lines, and their keys, that the drivers wrote before the tracer
PAIR_EVENTS = {
    "level": {"event", "level", "cost", "wall_s"},
    "iter": {"event", "level", "iter", "energy", "changed", "cps", "labels",
             "pmax", "setup_s", "unary_s", "fusion_s", "opt_s"},
    "warp": {"event", "level", "iter", "warp_s"},
    "level_distortion": {"event", "level"},
    "outputs": {"event", "wall_s"},
}
GROUP_EVENTS = {
    "level": {"event", "level", "cost", "init_s", "wall_s"},
    "iter": {"event", "level", "iter", "energy", "changed", "patch_overflow",
             "pmax", "devices", "maps_exchange", "colors", "setup_s",
             "opt_s", "setup_s_by_rank", "opt_s_by_rank",
             "pair_chunk_blocks", "pair_chunks_by_rank"},
    "warp": {"event", "level", "iter", "warp_s"},
    "outputs": {"event", "wall_s"},
    "ranks": {"event", "devices", "locate_launches", "locate_largest",
              "peak_device_bytes"},
}
# reader -> the tiny cell whose traced unit it reads
READERS = {
    "level_init_s.pair": "strain_warm",
    "fusion_ms_per_move.pair": "strain_warm",
    "host_wait_pct.pair": "strain_warm",
    "subject_post_s.pair": "strain_warm",
    "host_tables_s.pair": "strain_cli",
    "cli_start_s.pair": "strain_cli",
    "label_maps_s.group": "gmsm_s4",
    "iter_tables_s.group": "gmsm_s4",
    "regrow_s.group": "gmsm_s4",
    "host_wait_pct.group": "gmsm_s4",
}


@pytest.fixture(scope="module")
def bench():
    """msmbench's tiny cells and harness (importing its run module sets
    thread variables for the benchmark's own processes: put back)."""
    env, threads = dict(os.environ), torch.get_num_threads()
    from msmbench import harness, run
    from msmbench.tests import msmbench_tiny
    os.environ.clear()
    os.environ.update(env)
    torch.set_num_threads(2)         # as the tiny cells run in msmbench
    yield msmbench_tiny, harness, run
    torch.set_num_threads(threads)


def _entry(bench, name, tmp, trace_on, **traffic):
    tiny, harness, _ = bench
    os.makedirs(tmp, exist_ok=True)
    c = tiny.cell(name)
    c.traffic = dict(c.traffic, **traffic)
    entry = harness.load_module(c.entry_path, c.traffic["entry"]).Entry(
        c, SEED, CPU, tmp, trace_on)
    entry.setup()
    return entry


class _Walls:
    walls: list


def _unit(bench, name, tmp, trace_on=True, **traffic):
    """One unit of a tiny cell; returns (entry, the readers' context)."""
    entry = _entry(bench, name, tmp, trace_on, **traffic)
    t = time.perf_counter()
    entry.run_unit(0)
    window = _Walls()
    window.walls = [time.perf_counter() - t]
    assert not entry.units[0]["failed"], entry.units[0].get("error")
    ctx = bench[2].layer_context(entry, window, None, [], None)
    return entry, ctx


@pytest.fixture(scope="module")
def traced(bench, tmp_path_factory):
    """name -> the readers' context of one traced unit."""
    return {name: _unit(bench, name, tmp_path_factory.mktemp(name))[1]
            for name in ("strain_warm", "gmsm_s4", "strain_cli")}


def _events(ctx):
    (unit,) = ctx["units"]
    return unit["events"]


# -- off --------------------------------------------------------------------

def test_tracing_off_costs_no_sync_no_range_and_no_file(bench, tmp_path,
                                                        monkeypatch):
    """A pairwise subject (register_dataset) and a 2-subject cohort
    (run_gmsm) with no metrics path: no torch.cuda.synchronize, no
    profiler range (record_function of either kind), no tracer and no
    file."""
    calls = {"sync": 0, "range": 0, "tracer": 0}

    def counted(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(torch.cuda, "synchronize",
                        counted("sync", torch.cuda.synchronize))
    monkeypatch.setattr(torch.profiler, "record_function",
                        counted("range", torch.profiler.record_function))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        counted("range",
                                torch._C._profiler._RecordFunctionFast))
    monkeypatch.setattr(trace, "Tracer", counted("tracer", trace.Tracer))
    _unit(bench, "strain_warm", tmp_path / "pair", trace_on=False)
    tiny = bench[0]
    monkeypatch.setitem(tiny.TINY_GROUP, "it", "1,1")
    _unit(bench, "gmsm_s4", tmp_path / "group", trace_on=False,
          subjects_per_unit=2)
    assert calls == {"sync": 0, "range": 0, "tracer": 0}
    assert not [p for p in tmp_path.rglob("*.jsonl")]


def test_off_functions_return_at_once():
    assert not trace.active()
    assert trace.span("a") is trace.OFF and trace.mark("b") is trace.OFF
    with trace.span("a") as s:
        trace.count("c")
        trace.event("d", x=1)
    assert s.wall_s == 0.0
    x = torch.arange(3.0)
    assert trace.read(x.sum()) == 3.0 and trace.read(x) is x


# -- on ---------------------------------------------------------------------

@pytest.mark.parametrize("name", ["strain_warm", "gmsm_s4", "strain_cli"])
def test_spans_form_one_tree_a_unit(traced, name):
    """Every span line of a unit carries the unit's id; ids are unique;
    each parent is a span of the unit and holds its children in time."""
    spans = [e for e in _events(traced[name]) if e["event"] == "span"]
    assert spans
    assert len({s["unit"] for s in spans}) == 1
    by_id = {s["id"]: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s["t0_ns"] <= s["t1_ns"]
        assert s["wall_s"] == pytest.approx((s["t1_ns"] - s["t0_ns"]) * 1e-9,
                                            abs=2e-6)
        assert 0.0 <= s["wait_s"] <= s["wall_s"] + 1e-6
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["t0_ns"] <= s["t0_ns"] and s["t1_ns"] <= p["t1_ns"]


@pytest.mark.parametrize("name", ["strain_warm", "gmsm_s4"])
def test_level_children_cover_the_level(traced, name):
    """The child spans of each level (set-up, iterations, warps) hold at
    least 90 % of its wall."""
    spans = [e for e in _events(traced[name]) if e["event"] == "span"]
    levels = [s for s in spans if s["name"] == "level"]
    assert levels
    for lv in levels:
        inner = sum(s["wall_s"] for s in spans if s["parent"] == lv["id"])
        assert inner >= 0.9 * lv["wall_s"], (inner, lv)


@pytest.mark.parametrize("name,want", [("strain_warm", PAIR_EVENTS),
                                       ("strain_cli", PAIR_EVENTS),
                                       ("gmsm_s4", GROUP_EVENTS)])
def test_every_event_and_key_of_before_is_written(traced, name, want):
    events = _events(traced[name])
    stats = set(em.distortion_stats(np.zeros(4), np.zeros(4)))
    for event, keys in want.items():
        got = [e for e in events if e["event"] == event]
        assert got, event
        need = keys | (stats if event == "level_distortion" else set())
        for e in got:
            assert need <= set(e), (event, need - set(e))
    levels = [e for e in events if e["event"] == "level"]
    spans = {s["id"]: s for s in events if s["event"] == "span"}
    walls = [s["wall_s"] for s in spans.values() if s["name"] == "level"]
    np.testing.assert_allclose([e["wall_s"] for e in levels], walls,
                               atol=1e-4)


def test_stage_spans_counters(traced):
    """The counters each metric reads: fusion moves, AFFINE steps and cost
    evaluations (each a `rigid.twin` count on the CPU, and no `rigid.kernel`
    count), host tables, group alpha steps and regrows, the CLI's start-up
    marks."""
    pair = [e for e in _events(traced["strain_warm"]) if e["event"] == "span"]
    fusion = [s for s in pair if s["name"] == "fusion"]
    assert fusion and all(s["counters"]["fusion.move"]["n"] > 0
                          for s in fusion)
    (affine,) = [s for s in pair if s["name"] == "affine"]
    assert affine["counters"]["affine.step"]["n"] > 0
    assert affine["counters"]["cost_evals"] >= \
        3 * affine["counters"]["affine.step"]["n"]
    assert affine["counters"]["rigid.twin"] == \
        affine["counters"]["cost_evals"]
    assert affine["counters"].get("rigid.kernel", 0) == 0
    group = [e for e in _events(traced["gmsm_s4"]) if e["event"] == "span"]
    opts = [s for s in group if s["name"] == "opt"]
    assert opts and all("regrows" in s["counters"]
                        and s["counters"]["group.alpha"]["n"] > 0
                        for s in opts)
    assert {"group.maps", "group.iter_tables", "gmsm.lift", "gmsm.dedrift",
            "gmsm.resample", "gmsm.stats"} <= {s["name"] for s in group}
    cli = [e for e in _events(traced["strain_cli"]) if e["event"] == "span"]
    (start,) = [s for s in cli if s["name"] == "cli.start"]
    assert start["parent"] is None
    assert start["counters"]["cli.inputs"]["n"] == 1
    misses = sum(s["counters"].get("host_tables", {}).get("miss", 0)
                 for s in cli)
    assert misses > 0       # a fresh process builds its tables


def test_span_stamps_are_the_profilers_clock(tmp_path):
    """A span's t0_ns lies within 1 ms of the start of its record_function
    event in a CPU torch.profiler run."""
    from torch.profiler import ProfilerActivity, profile
    path = str(tmp_path / "m.jsonl")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.run(path, CPU):
            for _ in range(3):
                with trace.span("probe"):
                    with trace.mark("probe.step"):
                        torch.ones(64, 64) @ torch.ones(64, 64)
    starts = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == "probe")
    spans = [json.loads(line) for line in open(path)]
    assert len(starts) == len(spans) == 3
    for s, start in zip(spans, starts):
        assert abs(start - s["t0_ns"]) < 1_000_000, (start, s["t0_ns"])
        assert s["counters"]["probe.step"]["n"] == 1


def test_a_profiler_started_inside_a_span_gets_its_range(tmp_path):
    """The benchmark starts its profiler inside the last `level` span: the
    spans open then get a range at the next one entered, and the ranges
    are host ops (no user annotation the profiler would also lay on the
    device timeline)."""
    from torch.profiler import ProfilerActivity, profile
    with trace.run(str(tmp_path / "m.jsonl"), CPU):
        with trace.span("outer"):
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                with trace.span("inner"):
                    with trace.mark("step"):
                        torch.ones(8) + 1
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert {"outer", "inner", "step"} <= set(events)
    assert events["outer"].start_ns() <= events["inner"].start_ns()
    assert not any(events[n].is_user_annotation()
                   for n in ("outer", "inner", "step"))


def test_a_profiler_may_start_and_stop_inside_spans(tmp_path):
    """The benchmark's order: the profiler starts inside a level, the
    level ends while it runs, and it stops inside the next span; every
    span ends cleanly and the profiler keeps the ranges it saw."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU])
    with trace.run(str(tmp_path / "m.jsonl"), CPU):
        with trace.span("level"):
            prof.__enter__()
            with trace.span("level.init"):
                with trace.mark("host"):
                    torch.ones(8) + 1
        with trace.span("outputs"):
            prof.__exit__(None, None, None)
            with trace.span("after"):
                torch.ones(8) + 1
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert {"level", "level.init", "host", "outputs"} <= set(names)
    assert "after" not in names
    spans = [json.loads(line)["name"] for line in open(tmp_path / "m.jsonl")]
    assert spans == ["level.init", "level", "after", "outputs"]


def test_runs_nest_by_path(tmp_path):
    """A run inside one of the same path adopts its tracer (one unit, one
    write at the end); another path gets its own; off inside on is off."""
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    with trace.run(a, CPU) as outer:
        with trace.span("x"):
            with trace.run(a, CPU) as inner:
                assert inner is outer
                with trace.span("y"):
                    pass
            with trace.run(b, CPU) as other:
                assert other is not outer
                trace.event("e")
            assert os.path.exists(b) and not os.path.exists(a)
            with trace.run(None, CPU):
                assert not trace.active()
    lines = [json.loads(line) for line in open(a)]
    assert [e["name"] for e in lines] == ["y", "x"]
    assert lines[0]["parent"] == lines[1]["id"]
    assert len({e["unit"] for e in lines}) == 1


def test_lines_are_written_on_an_error(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with pytest.raises(ValueError):
        with trace.run(path, CPU):
            with trace.span("x"):
                trace.event("before")
                raise ValueError("boom")
    assert [json.loads(line)["event"] for line in open(path)] == \
        ["before", "span"]


def test_cached_counts_hits_and_misses(tmp_path):
    built = []

    @trace.cached(maxsize=1)
    def table(n):
        built.append(n)
        return np.arange(n)

    with trace.run(str(tmp_path / "m.jsonl"), CPU):
        with trace.span("x"):
            table(3)
            table(3)
            table(4)
            table(3)
    assert built == [3, 4, 3]
    (line,) = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
    c = line["counters"]["host_tables"]
    assert c["hit"] == 1 and c["miss"] == 3 and c["s"] >= 0.0
    assert table(3) is table(3)


def test_read_is_item_or_cpu_and_counts_as_wait(tmp_path):
    x = torch.tensor([1.5, 2.5])
    with trace.run(str(tmp_path / "m.jsonl"), CPU):
        with trace.span("x"):
            assert trace.read(x.sum()) == 4.0
            assert torch.equal(trace.read(x), x)
            assert trace.read(x > 2).tolist() == [False, True]


# -- the benchmark's span readers -------------------------------------------

@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_a_traced_unit_and_nothing_of_an_empty_one(
        bench, traced, metric):
    harness = bench[1]
    read = harness.load_module(harness.HERE / "layers" / f"{metric}.py",
                               metric).read
    value = read(traced[READERS[metric]])
    assert isinstance(value, float) and np.isfinite(value) and value >= 0.0
    if metric.startswith("host_wait_pct"):
        assert value <= 100.0
    empty = {"units": [{"subjects": 1, "wall_s": 1.0, "events": []}],
             "trace": None, "k1_calls": [], "peak_bytes": None}
    assert read(empty) is None
    # the events of a program without spans (only the older event lines)
    old = {"units": [dict(u, events=[e for e in u["events"]
                                     if e["event"] != "span"])
                     for u in traced[READERS[metric]]["units"]],
           "trace": None, "k1_calls": [], "peak_bytes": None}
    assert read(old) is None
