"""host_wait_pct.group: share of a gMSM cohort's wall in which the host
waited on the card: the `wait_s` of its top-level spans (levels,
outputs, lift, dedrift, resampling, statistics) over the cohort's
wall."""
from msmbench import spans


def read(ctx):
    return spans.host_wait_pct(ctx)
