"""group_setup_s.group: seconds a subject of the group driver's set-up
(reg/group.py, core/sparse.py, build_iteration_tables): the sum of the
`iter` events' setup_s and the `level` events' init_s."""
from msmbench import layerlib


def read(ctx):
    a = layerlib.event_sum(ctx, "iter", "setup_s")
    b = layerlib.event_sum(ctx, "level", "init_s")
    return None if a is None else a + (b or 0.0)
