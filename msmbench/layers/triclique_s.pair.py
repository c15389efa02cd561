"""triclique_s.pair: seconds a subject of the triclique likelihood
(reg/costs.py `triclique_likelihood`, called by reg/model.py's triplet
function in every fusion move and energy of a `--triclique` run): the
`triclique` spans."""
from msmbench import spans


def read(ctx):
    return spans.wall_per_subject(ctx, "triclique")
