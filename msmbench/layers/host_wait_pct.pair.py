"""host_wait_pct.pair: share of a pairwise unit's wall in which the host
waited on the card: the `wait_s` of its top-level spans (device reads
and closing syncs, every level's, AFFINE's included) over the unit's
wall."""
from msmbench import spans


def read(ctx):
    return spans.host_wait_pct(ctx)
