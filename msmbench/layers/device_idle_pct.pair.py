"""device_idle_pct.pair: share of the traced span of a pairwise
registration in which no operation ran on the card."""
from msmbench import layerlib


def read(ctx):
    return layerlib.device_idle_pct(ctx)
