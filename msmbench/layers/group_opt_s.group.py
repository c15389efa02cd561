"""group_opt_s.group: seconds a subject of the group optimiser
(parallel/group_fusion.py): the sum of the `iter` events' opt_s, the
pmax regrow included."""
from msmbench import layerlib


def read(ctx):
    return layerlib.event_sum(ctx, "iter", "opt_s")
