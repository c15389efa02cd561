"""warp_s.pair: seconds a subject of the warp after each iteration
(ops/resample.py, ops/nearest.py, ops/unfold.py): the sum of the `warp`
events' warp_s."""
from msmbench import layerlib


def read(ctx):
    return layerlib.event_sum(ctx, "warp", "warp_s")
