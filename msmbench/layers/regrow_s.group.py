"""regrow_s.group: seconds a subject of the group fusion calls redone
after a `pmax` regrow (reg/group.py): the `group.regrow` spans; 0 when
the `opt` spans' `regrows` counters say that none ran."""
from msmbench import layerlib, spans


def read(ctx):
    if spans.counter_total(ctx, "regrows") is None:
        return None
    return layerlib.per_subject(ctx, lambda u: sum(
        s["wall_s"] for s in spans.spans(u, "group.regrow")))
