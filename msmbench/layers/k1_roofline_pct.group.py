"""k1_roofline_pct.group: kernel K1's share of its roofline in the
traced span of a gMSM cohort (its last level): the least time an H100
needs for the work of K1's calls there, counted from their arguments,
over K1's kernel time in the device trace."""
from msmbench import layerlib


def read(ctx):
    return layerlib.k1_roofline_pct(ctx)
