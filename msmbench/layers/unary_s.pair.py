"""unary_s.pair: seconds a subject of the unary cost volumes
(reg/costs.py, ops/similarity.py, K1): the sum of the `iter` events'
unary_s."""
from msmbench import layerlib


def read(ctx):
    return layerlib.event_sum(ctx, "iter", "unary_s")
