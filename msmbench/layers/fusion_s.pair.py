"""fusion_s.pair: seconds a subject of the fusion optimiser
(reg/optimise/fusion.py): the sum of the `iter` events' fusion_s."""
from msmbench import layerlib


def read(ctx):
    return layerlib.event_sum(ctx, "iter", "fusion_s")
