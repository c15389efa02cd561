"""Similarity reductions over padded patch vectors.

Port of newmsm_tpu/ops/similarity.py (similarities.h:48-58,
similarities.cpp:129-253), vectorised over leading batch dims with an
explicit validity mask:

  1 = SSD            sqrt(sum w (a-b)^2) / n_valid
  2 = Pearson        1 - (1 + r_w) / 2
  4 = DICE           1 - 2|A∩B| / (|A|+|B|) on top-percentile masks
  5 = genDICE        size-normalised DICE variant
"""
from __future__ import annotations

import torch

SIM_SSD = 1
SIM_CORR = 2
SIM_DICE = 4
SIM_GENDICE = 5


def _count(mask):
    return torch.clamp(mask.sum(-1), min=1.0)


def weighted_ssd(a, b, w, mask):
    """(similarities.cpp:179-188): sqrt(sum w (a-b)^2) / n."""
    return torch.sqrt((w * mask * (a - b) ** 2).sum(-1)) / _count(mask)


def weighted_corr(a, b, w, mask):
    """Weighted Pearson correlation (similarities.cpp:129-158); returns r."""
    wm = w * mask
    s = wm.sum(-1)
    pos = s > 0
    safe_s = torch.where(pos, s, torch.ones_like(s))
    sum_a = (wm * a).sum(-1)
    sum_b = (wm * b).sum(-1)
    mean_a = torch.where(pos, sum_a / safe_s, sum_a)
    mean_b = torch.where(pos, sum_b / safe_s, sum_b)
    da = a - mean_a[..., None]
    db = b - mean_b[..., None]
    prod = (wm * da * db).sum(-1)
    var_a = (wm * da * da).sum(-1)
    var_b = (wm * db * db).sum(-1)
    prod = torch.where(pos, prod / safe_s, prod)
    var_a = torch.where(pos, var_a / safe_s, var_a)
    var_b = torch.where(pos, var_b / safe_s, var_b)
    denom = torch.sqrt(var_a) * torch.sqrt(var_b)
    r = prod / torch.where(denom > 0, denom, torch.ones_like(denom))
    return torch.where((var_a == 0) | (var_b == 0), torch.zeros_like(r), r)


def _percentile_threshold(x, mask, percentile):
    """Value at floor(percentile * n) rank among valid entries
    (similarities.cpp:201-226); padding sorts last."""
    big = torch.finfo(x.dtype).max
    xs = torch.sort(torch.where(mask > 0, x, torch.full_like(x, big)),
                    dim=-1).values
    nvalid = mask.sum(-1).to(torch.int64)
    idx = (percentile * nvalid).to(torch.int64).clamp(0, x.shape[-1] - 1)
    return torch.gather(xs, -1, idx[..., None])[..., 0]


def dice(a, b, mask, percentile=0.75, generalised=False):
    """DICE / genDICE on top-percentile masks (similarities.cpp:201-253).
    Returns 1 - overlap score (a cost)."""
    in_a = (a >= _percentile_threshold(a, mask, percentile)[..., None]) & (mask > 0)
    in_b = (b >= _percentile_threshold(b, mask, percentile)[..., None]) & (mask > 0)
    size_a = in_a.sum(-1).to(a.dtype)
    size_b = in_b.sum(-1).to(a.dtype)
    common = (in_a & in_b).sum(-1).to(a.dtype)
    tot = size_a + size_b
    denom = torch.where(tot > 0, tot, torch.ones_like(tot))
    if generalised:
        sb2 = torch.where(size_b > 0, size_b ** 2, torch.ones_like(size_b))
        return 1.0 - 2.0 * (common / sb2) / (denom / sb2)
    return 1.0 - 2.0 * common / denom


def sim_for_min(a, b, w, mask, simval: int, percentile: float = 0.75):
    """Dispatch matching get_sim_for_min (similarities.h:48-58)."""
    if simval == SIM_SSD:
        return weighted_ssd(a, b, w, mask)
    if simval == SIM_CORR:
        return 1.0 - (1.0 + weighted_corr(a, b, w, mask)) * 0.5
    if simval == SIM_DICE:
        return dice(a, b, mask, percentile)
    if simval == SIM_GENDICE:
        return dice(a, b, mask, percentile, generalised=True)
    raise ValueError(f"unknown similarity metric {simval}")
