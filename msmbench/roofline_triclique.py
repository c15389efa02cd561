"""The yardstick of the triclique likelihood (`--triclique`,
`reg/costs.py::triclique_likelihood`): the useful work of one call,
counted from the masked-in slots of its face patches (the `triclique`
spans' `valid` counter: the slots that carry a source vertex, times the
label combinations) and the level's shape (the `triclique.shape` event:
channels D, the target icosphere's res), and the least time an H100 needs
for it, at the data-sheet peaks of roofline.py.

One valid query is one source vertex of a CP triangle's patch under one
combination of the corners' labels. Its work:
  bytes: K1's (roofline.BYTES_PER_QUERY: the point in, the face and three
    weights out) and the target data gathered, 3 corners x D float32;
  operations: K1's (roofline.flops_per_query(res)); the point re-placed at
    the deformed corners, 3 x 3 multiply-adds and the normalisation back
    onto the sphere (3 squares, 2 adds, a square root, 3 divisions, 3
    multiplies) = 30; the target value, 3 x D multiply-adds = 6 D; the
    similarity: with D > 1 (multivariate) a weighted Pearson correlation
    over the D channels (sums of w, w a, w b: 5 D; deviations: 2 D;
    w da db, w da da, w db db: 9 D; 4 divisions, a square root, a product
    and a division, and the patch mean's add and compare: 10) = 16 D +
    10; with D = 1 (univariate) the same sums run over the patch, 16 a
    query, and the patch's closing operations are not counted.
Padded slots are not counted, so the count does not change when a later
change packs the patches, and the share cannot pass 100 %.
"""
from __future__ import annotations

from . import roofline

REPLACE_FLOPS = 30


def bytes_per_query(D: int) -> int:
    return roofline.BYTES_PER_QUERY + 3 * D * 4


def flops_per_query(D: int, res: int) -> float:
    sim = 16 * D + (10 if D > 1 else 0)
    return roofline.flops_per_query(res) + REPLACE_FLOPS + 6 * D + sim


def least_seconds(valid: int, D: int, res: int) -> float:
    """Least time the card needs for `valid` queries of a level with D
    channels on a level-`res` target."""
    return max(valid * bytes_per_query(D) / roofline.PEAK_BYTES_PER_S,
               valid * flops_per_query(D, res) / roofline.PEAK_FP32_FLOPS)
