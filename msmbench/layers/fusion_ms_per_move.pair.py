"""fusion_ms_per_move.pair: milliseconds a binary fusion move
(reg/optimise/fusion.py, one `fusion_optimize` alpha): the `fusion`
spans' wall over the count of their `fusion.move` marks."""
from msmbench import spans


def read(ctx):
    wall = spans.wall_per_subject(ctx, "fusion")
    moves = spans.counter_total(ctx, "fusion.move", "n")
    if wall is None or not moves:
        return None
    subjects = sum(u["subjects"] for u in ctx["units"] if u["events"])
    return 1000.0 * wall * subjects / moves
