"""level_init_s.pair: seconds a subject of the discrete levels' set-up
(reg/driver.py `_initialize_level`: featurespace, PairwiseModel, host
tables, the previous levels' warp projected onto the level's grids): the
`level.init` spans of the levels that run no AFFINE step."""
from msmbench import spans


def _discrete(unit, init):
    level = [s for s in spans.spans(unit, "level")
             if s["id"] == init["parent"] and s["unit"] == init["unit"]]
    return bool(level) and not any(
        c["name"] == "affine" for c in spans.children(unit, level[0]))


def read(ctx):
    return spans.wall_per_subject(ctx, "level.init", _discrete)
