"""iter_setup_s.pair: seconds a subject of the discrete iterations'
set-up (reg/driver.py, reg/model.py, reg/featurespace.py): the sum of the
`iter` events' setup_s, which holds the cold host-table builds of a
fresh process."""
from msmbench import layerlib


def read(ctx):
    return layerlib.event_sum(ctx, "iter", "setup_s")
