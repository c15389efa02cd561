"""Faults planted in the program's optimiser, from outside, for the upper
readings of the limits of `correct` (msmbench/calibrate.py) and for the
tests; never used by a benchmark run. `install(name)` puts the fault on
and returns the function that takes it off.

- bf16_costs: the optimiser's data costs rounded to bfloat16 (the pairwise
  cost volume, `reg.costs.unary_costs`; the group pair blocks,
  `GroupFusion.pair_block_cost`): the optimiser one precision down.
- half_alphas: every other candidate label's move skipped (pairwise
  `fusion_binary_solve`, group `GroupFusion.alpha_step`).
- half_subjects: the group step keeps the second half of the cohort's
  subjects where they were.
- no_regrow: the group step reports no patch truncation, so the `pmax`
  regrow never runs.
"""
from __future__ import annotations

import numpy as np


def _bf16(t):
    import torch
    return t.to(torch.bfloat16).to(t.dtype)


def _bf16_costs():
    from newmsm_tpu_torch.parallel import group_fusion as GF
    from newmsm_tpu_torch.reg import costs
    unary, pair = costs.unary_costs, GF.GroupFusion.pair_block_cost
    costs.unary_costs = lambda *a, **k: _bf16(unary(*a, **k))
    GF.GroupFusion.pair_block_cost = \
        lambda self, *a, **k: _bf16(pair(self, *a, **k))

    def remove():
        costs.unary_costs, GF.GroupFusion.pair_block_cost = unary, pair
    return remove


def _half_alphas():
    import torch
    from newmsm_tpu_torch.parallel import group_fusion as GF
    from newmsm_tpu_torch.reg.optimise import fusion
    solve, step = fusion.fusion_binary_solve, GF.GroupFusion.alpha_step

    def half_solve(labeling, alpha, *a, **k):
        if alpha % 2:
            return torch.zeros_like(labeling)
        return solve(labeling, alpha, *a, **k)

    def half_step(self, state, maps, partner, tables, pair_nodes, labeling,
                  alpha):
        if alpha % 2:
            return labeling
        return step(self, state, maps, partner, tables, pair_nodes,
                    labeling, alpha)

    fusion.fusion_binary_solve = half_solve
    GF.GroupFusion.alpha_step = half_step

    def remove():
        fusion.fusion_binary_solve, GF.GroupFusion.alpha_step = solve, step
    return remove


def _group_call(change):
    """Wrap GroupFusion.__call__; change(self, start, result) -> result."""
    from newmsm_tpu_torch.parallel import group_fusion as GF
    call = GF.GroupFusion.__call__

    def wrapped(self, maps, cp, spac, labeling, partner, tables):
        return change(self, labeling,
                      call(self, maps, cp, spac, labeling, partner, tables))

    GF.GroupFusion.__call__ = wrapped

    def remove():
        GF.GroupFusion.__call__ = call
    return remove


def _half_subjects():
    def keep_half(self, start, result):
        labeling, energy, need = result
        lab = labeling.reshape(self.S, self.K).clone()
        lab[self.S // 2:] = start.reshape(self.S, self.K)[self.S // 2:]
        return lab.reshape(-1), energy, need
    return _group_call(keep_half)


def _no_regrow():
    return _group_call(lambda self, start, result: (result[0], result[1], 0))


FAULTS = {"bf16_costs": _bf16_costs, "half_alphas": _half_alphas,
          "half_subjects": _half_subjects, "no_regrow": _no_regrow}


def install(name: str):
    return FAULTS[name]()


def perturb(data: dict, seed: int, scale: float = 1e-6) -> None:
    """Multiply every subject's data in place by 1 + scale * N(0, 1): a few
    float32 roundings, so that a sound run reads what a change of
    summation order inside the program could make it read."""
    rng = np.random.default_rng(int(seed))
    for sid in sorted(data):
        d = data[sid]
        data[sid] = d * (1.0 + scale * rng.standard_normal(d.shape))
