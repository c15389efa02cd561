"""gmsm_post_s.group: seconds a subject of run_gmsm outside the levels
(pipelines/gmsm.py: writing the registrations, the lift, the dedrift,
the resampling, the maps and the statistics): the cohort's wall less its
level walls."""
from msmbench import layerlib


def read(ctx):
    return layerlib.outside_levels(ctx)
