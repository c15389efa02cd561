"""Shared arithmetic of the per-layer readers that read the program's span
lines (newmsm_tpu_torch/trace.py: {"event": "span", "name", "id", "parent",
"unit", "t0_ns", "t1_ns", "wall_s", "wait_s", "counters"}), written in
every unit of a traced run. Each function returns None when the units
carry no span or counter of the kind it reads (a program without them)."""
from __future__ import annotations

from msmbench import layerlib


def spans(unit, name=None) -> list:
    return [e for e in unit["events"] if e["event"] == "span"
            and (name is None or e["name"] == name)]


def _units(ctx, name):
    units = [u for u in ctx["units"] if u["events"]]
    if not any(spans(u, name) for u in units):
        return None
    return units


def wall_per_subject(ctx, name, when=lambda unit, span: True):
    """Seconds a subject of the `name` spans (those `when` keeps)."""
    if _units(ctx, name) is None:
        return None
    return layerlib.per_subject(ctx, lambda u: sum(
        s["wall_s"] for s in spans(u, name) if when(u, s)))


def counter_total(ctx, counter, key=None):
    """The sum over every span of every traced unit of counters[counter]
    (or of its field `key`); None when no span has that counter."""
    found, total = False, 0
    for u in ctx["units"]:
        for s in spans(u):
            c = s["counters"].get(counter)
            if c is None:
                continue
            found = True
            total += c if key is None else c[key]
    return total if found else None


def children(unit, span) -> list:
    return [s for s in spans(unit) if s["parent"] == span["id"]
            and s["unit"] == span["unit"]]


def host_wait_pct(ctx):
    """Host seconds blocked on the device inside the top-level spans of
    each traced unit, over the units' walls, in percent."""
    units = _units(ctx, None)
    if units is None:
        return None
    wait = sum(s["wait_s"] for u in units for s in spans(u)
               if s["parent"] is None)
    wall = sum(u["wall_s"] for u in units)
    return 100.0 * wait / wall if wall > 0 else None
