"""triclique_roofline_pct.pair: the triclique likelihood's share of its
roofline: the least time an H100 needs for the useful work of every
`triclique` span of the traced units (msmbench/roofline_triclique.py,
counted from the spans' `valid` counters and the level's
`triclique.shape` event, which precedes the level's spans) over those
spans' wall, in percent."""
from msmbench import roofline_triclique, spans


def read(ctx):
    least = wall = 0.0
    for unit in ctx["units"]:
        shape = None
        for e in unit["events"]:
            if e["event"] == "triclique.shape":
                shape = e
            elif (e["event"] == "span" and e["name"] == "triclique"
                  and shape is not None and "valid" in e["counters"]):
                least += roofline_triclique.least_seconds(
                    e["counters"]["valid"], shape["D"], shape["res"])
                wall += e["wall_s"]
    if wall <= 0 or least <= 0:
        return None
    return 100.0 * least / wall
