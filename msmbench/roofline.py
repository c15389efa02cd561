"""The yardstick of kernel K1 (the pristine-icosphere locate,
`newmsm_tpu_torch/csrc/locate_bary.cu`): the work one call needs, counted
from its arguments, and the least time an H100 needs for it.

A copy of the count in `newmsm_tpu_torch/ops/locate_bench.py`, kept here
so that the program cannot change the yardstick it is measured by.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit
PEAK_FP32_FLOPS = 67e12        # FP32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12     # HBM3
BYTES_PER_QUERY = 28           # 3 f32 in; 1 i32 + 3 f32 out


def flops_per_query(res: int) -> int:
    """Floating-point operations the locate algorithm needs for one query
    (add, multiply, min, compare, divide, sqrt and rsqrt count 1, a fused
    multiply-add 2; selects and integer work count 0):
      normalise 9; base scan 20 x (3 dots x 5 + 2 min + 1 compare) = 360;
      chosen face's 3 carried dots 15 and orientation sign 18;
      per level 3 midpoints x 12 + 3 cross products x 9 + 3 plane
      distances x 12 + 8 min + 3 compare = 110;
      weights: normal 15, projection 14, 3 areas x 22, total 2, 3
      divisions = 100."""
    return 9 + 360 + (15 + 18 if res > 0 else 0) + 110 * res + 100


def least_seconds(calls) -> float:
    """Least time the card needs for `calls`, a list of (queries, res):
    for each call the larger of its bytes over the memory rate and its
    operations over the FP32 rate, summed."""
    total = 0.0
    for n, res in calls:
        total += max(n * BYTES_PER_QUERY / PEAK_BYTES_PER_S,
                     n * flops_per_query(res) / PEAK_FP32_FLOPS)
    return total
