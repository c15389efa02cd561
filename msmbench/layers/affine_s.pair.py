"""affine_s.pair: seconds a subject of the AFFINE level (reg/rigid.py),
the level-1 `level` event wall."""
from msmbench import layerlib


def read(ctx):
    return layerlib.event_sum(ctx, "level", "wall_s",
                              lambda e: e.get("cost") in ("AFFINE", "RIGID"))
