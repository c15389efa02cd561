"""device_idle_pct.group: share of the traced span of a gMSM cohort in
which no operation ran on the card."""
from msmbench import layerlib


def read(ctx):
    return layerlib.device_idle_pct(ctx)
