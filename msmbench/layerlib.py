"""Shared arithmetic of the per-layer readers (msmbench/layers/): each
reader reads the units that carry the program's metrics events and gives
seconds a subject, or None when it finds nothing to read."""
from __future__ import annotations

from . import roofline


def _traced(ctx):
    return [u for u in ctx["units"] if u["events"]]


def per_subject(ctx, per_unit) -> float | None:
    """Sum of per_unit(unit) over the traced units, over their subjects."""
    units = _traced(ctx)
    if not units:
        return None
    return sum(per_unit(u) for u in units) / sum(u["subjects"] for u in units)


def event_sum(ctx, event: str, key: str, when=lambda e: True):
    """Seconds a subject of `key` summed over the `event` events."""
    return per_subject(ctx, lambda u: sum(
        e[key] for e in u["events"] if e["event"] == event and key in e
        and when(e)))


def outside_levels(ctx):
    """Seconds a subject of the unit's wall that no level's wall holds."""
    return per_subject(ctx, lambda u: u["wall_s"] - sum(
        e["wall_s"] for e in u["events"] if e["event"] == "level"))


def k1_roofline_pct(ctx):
    """K1's least time for the work of its calls in the traced span over
    its kernel time there, in percent."""
    tr = ctx["trace"]
    if not tr or tr["k1_kernel_s"] <= 0 or not ctx["k1_calls"]:
        return None
    return 100.0 * roofline.least_seconds(ctx["k1_calls"]) / tr["k1_kernel_s"]


def device_idle_pct(ctx):
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def peak_mem_gib(ctx):
    return ctx["peak_bytes"] / 2 ** 30 if ctx["peak_bytes"] else None
