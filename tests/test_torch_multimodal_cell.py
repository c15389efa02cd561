"""The benchmark's multimodal cell `hcp_multimodal_ico6` on the CPU, at
ico-3 (msmbench/tests/msmbench_tiny_multimodal.py): a run through
`run.run_cell` ends `correct`, its likelihood held against the plain
reference; a unit that kept no likelihood call makes it not correct;
with no sync, no profiler range and no face-patch read while
tracing is off; traced, the `triclique` span comes once a likelihood call
(each fusion move and each energy), with its `queries` and `valid`
counters, one `triclique.shape` event a level, and the two new readers
read them and nothing of a program without them."""
from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def bench():
    """msmbench's tiny multimodal cell and harness (importing its run
    module sets thread variables for the benchmark's own processes: put
    back)."""
    env, threads = dict(os.environ), torch.get_num_threads()
    from msmbench import harness, run
    from msmbench.tests import msmbench_tiny_multimodal as tiny
    os.environ.clear()
    os.environ.update(env)
    torch.set_num_threads(2)
    yield tiny, harness, run
    torch.set_num_threads(threads)


def _face_valid(monkeypatch):
    """Record the model's `face_valid` after each iteration's set-up."""
    from newmsm_tpu_torch.reg.model import PairwiseModel
    seen, setup = [], PairwiseModel.setup_iteration

    def recorded(self, *a, **k):
        out = setup(self, *a, **k)
        seen.append((self.face_valid, int(out["face_mask"].sum())))
        return out
    monkeypatch.setattr(PairwiseModel, "setup_iteration", recorded)
    return seen


def test_tiny_cell_is_correct_and_costs_nothing_untraced(bench, monkeypatch):
    """One untraced unit: `correct`, the kept likelihood call recomputed by
    the reference (lik_off_share 0 over its entries), and no
    torch.cuda.synchronize, no profiler range (of either kind) and no read
    of the face patches' valid count."""
    from newmsm_tpu_torch import trace
    tiny = bench[0]
    calls = {"sync": 0, "range": 0}

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
    valid = _face_valid(monkeypatch)
    result, lines = tiny.run_tiny()
    assert result["correct"], lines
    assert result["attempted"] == 1 and result["failed"] == 0
    assert result["checks"]["lik_off_share"]["value"] == 0.0
    info = next(line for line in lines if "reference info " in line)
    assert '"lik_entries": 2560' in info     # T = 320 faces x 8
    assert calls == {"sync": 0, "range": 0}
    assert valid and all(v == 0 for v, _ in valid)
    assert not trace.active()


def test_a_unit_that_kept_no_likelihood_call_is_not_correct(bench,
                                                             tmp_path):
    """Two units, the likelihood hook taken off before the second: the
    judge counts the second unit's call as missing (lik_missing 1) and as a
    whole call off (half of the entries), and the run is not correct."""
    tiny, harness, _ = bench
    from msmbench.reference import judge
    c = tiny.cell()
    entry = harness.load_module(c.entry_path, c.traffic["entry"]).Entry(
        c, tiny.SEED, CPU, tmp_path, False)
    try:
        entry.setup()
        entry.run_unit(0)
        hook = [h for h in entry.hooks
                if h.__qualname__.startswith("likelihood_hook")]
        assert len(hook) == 1
        entry.hooks.remove(hook[0])
        hook[0]()
        entry.run_unit(1)
        assert not any(u["failed"] for u in entry.units)
        entry.release()
        numbers = entry.judge()
    finally:
        entry.close()
    ok, checks = judge.checks(numbers, c.limits)
    assert not ok
    assert checks["lik_missing"] == {"value": 1, "limit": 0, "ok": False,
                                     "kind": "max"}
    assert numbers["lik_off_share"] == 0.5
    assert numbers["info"]["lik_entries"] == 2 * 2560
    assert checks["patch_off"]["ok"] and numbers["patch_off"] == 0
    assert all(v["ok"] for k, v in checks.items()
               if k not in ("lik_missing", "lik_off_share"))


@pytest.fixture(scope="module")
def traced(bench, tmp_path_factory):
    """One traced unit of the tiny cell: (its events, the readers'
    context, the face patches' valid counts by iteration)."""
    tiny, harness, run = bench
    mp = pytest.MonkeyPatch()
    try:
        valid = _face_valid(mp)
        tmp = tmp_path_factory.mktemp("multimodal")
        c = tiny.cell()
        entry = harness.load_module(c.entry_path, c.traffic["entry"]).Entry(
            c, tiny.SEED, CPU, tmp, True)
        try:
            entry.setup()
            t = time.perf_counter()
            entry.run_unit(0)
            wall = time.perf_counter() - t
            assert not entry.units[0]["failed"], entry.units[0].get("error")

            class Window:
                walls = [wall]
            ctx = run.layer_context(entry, Window, None, [], None)
        finally:
            entry.close()
    finally:
        mp.undo()
    (unit,) = ctx["units"]
    return unit["events"], ctx, valid


def test_triclique_span_once_a_likelihood_call(traced):
    """Every fusion move and every energy evaluates the likelihood once,
    inside one `triclique` span under the `fusion` span, whose counters are
    what K1 is sent (T x C x fmax) and the slots that carry data (C x the
    masked-in slots of the iteration's face patches)."""
    events, _, valid = traced
    spans = [e for e in events if e["event"] == "span"]
    fusion = [s for s in spans if s["name"] == "fusion"]
    tri = [s for s in spans if s["name"] == "triclique"]
    moves = sum(s["counters"]["fusion.move"]["n"] for s in fusion)
    assert len(tri) == moves + len(fusion)
    ids = {s["id"]: s for s in spans}
    assert all(ids[s["parent"]]["name"] == "fusion" for s in tri)
    shapes = [e for e in events if e["event"] == "triclique.shape"]
    assert [e["level"] for e in events if e["event"] == "level"] == [1, 2]
    assert len(shapes) == 2
    assert all(e["D"] == 10 and e["res"] == 3 for e in shapes)
    assert [e["T"] for e in shapes] == [80, 320]
    # per fusion span (one iteration): every call's counters
    assert len(valid) == len(fusion)
    by_fusion = {f["id"]: (f, v) for f, (v, _) in zip(fusion, valid)}
    level = -1
    for e in events:
        if e["event"] == "triclique.shape":
            level += 1
            shape = shapes[level]
        if e["event"] != "span" or e["name"] != "triclique":
            continue
        _, n_valid = by_fusion[e["parent"]]
        c = e["counters"]
        n_comb = c["queries"] // (shape["T"] * shape["fmax"])
        assert n_comb in (1, 8)
        assert c["queries"] == shape["T"] * n_comb * shape["fmax"]
        assert c["valid"] == n_comb * n_valid
        assert 0 < c["valid"] <= c["queries"]
    # traced, the valid count is the face patches' masked-in slots
    assert all(v == n > 0 for v, n in valid)


@pytest.mark.parametrize("metric", ["triclique_s.pair",
                                    "triclique_roofline_pct.pair"])
def test_readers_read_the_traced_unit_and_nothing_of_a_program_without(
        bench, traced, metric):
    harness = bench[1]
    _, ctx, _ = traced
    read = harness.load_module(harness.HERE / "layers" / f"{metric}.py",
                               metric).read
    value = read(ctx)
    assert isinstance(value, float) and np.isfinite(value) and value > 0.0
    if metric.startswith("triclique_roofline"):
        assert value <= 100.0
    else:
        assert value <= ctx["units"][0]["wall_s"]
    old = {"units": [dict(u, events=[
        e for e in u["events"] if e["event"] != "triclique.shape"
        and not (e["event"] == "span" and e["name"] == "triclique")])
        for u in ctx["units"]],
        "trace": None, "k1_calls": [], "peak_bytes": None}
    assert read(old) is None
