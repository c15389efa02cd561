"""outside_levels_s.pair: seconds a subject of the entry outside the
levels (pipelines/cohort.py or cli.py: start-up, inputs, outputs,
statistics): the unit's wall less its level walls. In a traced run it
also holds the per-level distortion the driver adds under --metrics."""
from msmbench import layerlib


def read(ctx):
    return layerlib.outside_levels(ctx)
