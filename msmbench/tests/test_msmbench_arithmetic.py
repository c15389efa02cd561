"""The benchmark's own arithmetic on the CPU: the whole-unit window, the
busy-share union and its reduction of a trace, and the K1 work count
against the program's locate_bench at the same arguments."""
from __future__ import annotations

import pytest

from msmbench import harness, layerlib, roofline


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def run_window(seconds, unit_walls):
    """Units of the given walls through a Window; returns (window, units
    run)."""
    clock = FakeClock()
    w = harness.Window(seconds, clock)
    w.open()
    n = 0
    while w.more() and n < len(unit_walls):
        clock.t += unit_walls[n]
        w.close_unit()
        n += 1
    return w, n


def test_window_runs_whole_units_while_the_mean_fits():
    # 10 s units in 45 s: after 4 units 5 s are left, less than the mean
    w, n = run_window(45, [10.0] * 10)
    assert n == 4
    assert w.elapsed == pytest.approx(40.0)
    assert w.seconds_per_subject(4) == pytest.approx(10.0)


def test_window_always_runs_one_unit_and_counts_its_overrun():
    w, n = run_window(10, [37.0, 37.0])
    assert n == 1
    assert w.seconds_per_subject(8) == pytest.approx(37.0 / 8)


def test_window_starts_a_unit_when_exactly_the_mean_is_left():
    w, n = run_window(30, [10.0, 10.0, 10.0, 10.0])
    assert n == 3


def test_window_rate_is_over_completed_subjects_not_a_median():
    # after 30 s, 15 s are left, the mean is 10 s: the fourth unit starts
    # and overruns; the rate takes all of it
    w, n = run_window(45, [5.0, 15.0, 10.0, 30.0, 1.0])
    assert n == 4
    assert w.seconds_per_subject(4) == pytest.approx(15.0)


def test_union_of_intervals():
    assert harness.union_seconds([(0, 1), (0.5, 2), (3, 4)]) == 3.0
    assert harness.union_seconds([(3, 4), (0, 10)]) == 10.0
    assert harness.union_seconds([]) == 0.0


def test_idle_gaps():
    gaps = harness.idle_gaps([(1, 2), (1.5, 3), (5, 6)], 0, 8)
    assert gaps == [(0, 1), (3, 5), (6, 8)]


def test_reduce_events_busy_share_k1_and_named_gaps():
    events = [
        ("outer", "DeviceType.CPU", 0.0, 10.0),
        ("aten::nonzero", "DeviceType.CPU", 2.0, 4.0),
        ("void locate_bary_kernel<6>(...)", "DeviceType.CUDA", 0.5, 1.0),
        ("elementwise", "DeviceType.CUDA", 1.0, 1.0),
        ("elementwise", "DeviceType.CUDA", 8.0, 1.0),
    ]
    s = harness.reduce_events(events)
    assert s["busy_s"] == pytest.approx(2.5)
    assert s["window_s"] == pytest.approx(10.0)
    assert s["k1_kernel_s"] == pytest.approx(1.0)
    assert s["device_ops"][0] == ["elementwise", 2.0]
    # the longest gap, 2-8, has aten::nonzero running at its middle (5)
    assert s["idle_gaps"][0] == ["aten::nonzero", pytest.approx(6.0)]
    assert layerlib.device_idle_pct({"trace": s}) == pytest.approx(75.0)


def test_an_idle_gap_between_ops_is_named_by_the_op_before():
    events = [("aten::item", "DeviceType.CPU", 0.0, 1.0),
              ("k", "DeviceType.CUDA", 0.0, 0.5),
              ("k", "DeviceType.CUDA", 4.0, 1.0)]
    s = harness.reduce_events(events)
    assert s["idle_gaps"][0] == ["after aten::item", pytest.approx(3.5)]
    assert layerlib.device_idle_pct({"trace": s}) == pytest.approx(70.0)


@pytest.mark.parametrize("res", range(0, 13))
def test_k1_work_count_is_locate_bench_count(res):
    from newmsm_tpu_torch.ops import locate_bench
    assert roofline.flops_per_query(res) == locate_bench.flops_per_query(res)
    assert roofline.BYTES_PER_QUERY == locate_bench.BYTES_PER_QUERY
    assert roofline.PEAK_FP32_FLOPS == locate_bench.PEAK_FP32_FLOPS
    assert roofline.PEAK_BYTES_PER_S == locate_bench.PEAK_BYTES_PER_S
    for n in (983_808, 40_962, 1):
        want = locate_bench.roofline(res, n)["bound_ms"] * 1e-3
        assert roofline.least_seconds([(n, res)]) == pytest.approx(want)


def test_k1_roofline_share_from_calls_and_kernel_time():
    calls = [(983_808, 6), (40_962, 6)]
    least = roofline.least_seconds(calls)
    ctx = {"trace": {"k1_kernel_s": 2 * least}, "k1_calls": calls}
    assert layerlib.k1_roofline_pct(ctx) == pytest.approx(50.0)
    assert layerlib.k1_roofline_pct({"trace": None, "k1_calls": calls}) \
        is None
    assert layerlib.k1_roofline_pct(
        {"trace": {"k1_kernel_s": 0.0}, "k1_calls": []}) is None


def test_layer_readers_divide_by_traced_subjects():
    ctx = {"units": [
        {"subjects": 1, "wall_s": 10.0, "events": [
            {"event": "level", "cost": "AFFINE", "wall_s": 2.0},
            {"event": "level", "cost": "DISCRETE", "wall_s": 7.0},
            {"event": "iter", "setup_s": 0.5, "unary_s": 0.1,
             "fusion_s": 1.0}]},
        {"subjects": 1, "wall_s": 12.0, "events": [
            {"event": "level", "cost": "AFFINE", "wall_s": 4.0},
            {"event": "level", "cost": "DISCRETE", "wall_s": 7.0}]},
        {"subjects": 1, "wall_s": 11.0, "events": []}]}
    assert layerlib.event_sum(ctx, "level", "wall_s",
                              lambda e: e["cost"] == "AFFINE") == 3.0
    assert layerlib.outside_levels(ctx) == pytest.approx(2.0 / 2)
    assert layerlib.event_sum(ctx, "iter", "fusion_s") == 0.5


def test_band_numbers_average_over_banded_subjects_and_count_the_rest():
    from msmbench.reference import judge
    bands = {"1": {"cc": 0.5, "warp_ratio": 0.6},
             "2": {"cc": 0.7, "warp_ratio": 0.4}}
    scores = {1: {"cc": 0.48, "warp_ratio": 0.65},
              2: {"cc": 0.71, "warp_ratio": 0.41},
              3: {"cc": 0.1, "warp_ratio": 0.9}}
    got = judge.band_numbers(scores, bands)
    assert got["cc_drop"] == pytest.approx((0.02 - 0.01) / 2)
    assert got["warp_rise"] == pytest.approx((0.05 + 0.01) / 2)
    assert got["unbanded"] == 1
    better = judge.band_numbers({2: {"cc": 0.8, "warp_ratio": 0.3}}, bands)
    assert better["cc_drop"] == pytest.approx(-0.1)
    assert better["warp_rise"] == pytest.approx(-0.1)
    assert better["unbanded"] == 0
