"""`correct` on the CPU at ico-3: a sound run of each tiny cell is correct,
and so is one whose inputs carry a rounding's worth of noise; the timed
path broken underneath makes it false, once for each fault the cell can
have (the cells run on one chip, so no exchange between chips can be left
out), and so does the optimiser broken (msmbench/faults.py); and the
control (the reference computed a precision lower, in the program's
place) fails the cells' own limits."""
from __future__ import annotations

import os
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from msmbench import calibrate, faults, harness, run
from msmbench.reference import judge
from msmbench_tiny import TINY_CELLS, cell, run_tiny


@pytest.mark.parametrize("name", ["strain_warm", "strain_cli", "gmsm_s4"])
def test_a_sound_run_is_correct(name):
    result, lines = run_tiny(name)
    assert result["correct"], "\n".join(lines)
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert lines[-1].startswith("check ")


def test_a_traced_run_reports_the_cells_per_layer_metrics():
    result, lines = run_tiny("strain_warm", trace=True)
    assert result["correct"], "\n".join(lines)
    for name in ("affine_s.pair", "fusion_s.pair", "unary_s.pair",
                 "iter_setup_s.pair", "warp_s.pair",
                 "outside_levels_s.pair"):
        assert result["metrics"][name]["value"] > 0, name
    assert result["device"]["window_s"] > 0
    assert "breakdown" in result


def test_a_traced_line_without_a_listed_metric_is_named():
    c = cell("strain_warm")
    names = [m["name"] for m in c.per_layer]
    full = {"metrics": {n: {"value": 1.0} for n in names}}
    assert run.silent_metrics(c, full, True) == []
    short = {"metrics": {n: {"value": 1.0} for n in names[1:]}}
    assert run.silent_metrics(c, short, True) == names[:1]
    assert run.silent_metrics(c, {"metrics": {}}, False) == []


# -- faults planted in the program under the timed path -------------------

def _state_unchanged(monkeypatch):
    """Every registration step returns its state unchanged."""
    from newmsm_tpu_torch.reg import driver, group

    def no_pair_step(self, level):
        self.sph_reg = self._project_cpgrid()

    monkeypatch.setattr(driver.MeshRegistration, "_evaluate", no_pair_step)
    monkeypatch.setattr(group.GroupMeshRegistration, "_evaluate",
                        lambda self, level: None)


def _answer_altered(monkeypatch):
    """The resampled data altered where it is produced."""
    from newmsm_tpu_torch.ops import resample
    orig = resample.metric_resample

    def altered(*a, **k):
        out, excl = orig(*a, **k)
        out.data = out.data + 1e-3
        return out, excl

    monkeypatch.setattr(resample, "metric_resample", altered)


def _half_the_batch(monkeypatch):
    """Pairwise: every other subject of the window is left out. Groupwise:
    the cohort's mean and stdev maps and its CC taken over half of its
    subjects."""
    from newmsm_tpu_torch.eval import metrics
    from newmsm_tpu_torch.pipelines import cohort, gmsm
    calls = []
    orig_reg = cohort.register_dataset

    def half_registered(subjects, *a, **k):
        calls.append(1)
        if len(calls) % 2 == 0:
            return cohort.DatasetResult()
        return orig_reg(subjects, *a, **k)

    orig_gmsm = gmsm.run_gmsm

    def half_mean(*a, **k):
        res = orig_gmsm(*a, **k)
        half = res.resampled_data[:max(1, len(res.resampled_data) // 2)]
        stack = np.stack(half)
        res.mean_map, res.stdev_map = stack.mean(0), stack.std(0)
        res.stats["cc"] = metrics.mean_pairwise_cc([r[0] for r in half]) \
            if len(half) > 1 else res.stats["cc"]
        return res

    monkeypatch.setattr(cohort, "register_dataset", half_registered)
    monkeypatch.setattr(gmsm, "run_gmsm", half_mean)


FAULTS = {"state_unchanged": _state_unchanged,
          "answer_altered": _answer_altered,
          "half_the_batch": _half_the_batch}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["strain_warm", "gmsm_s4"])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, lines = run_tiny(name, seconds=1e9)
    assert not result["correct"], "\n".join(lines)


SITE = {
    "state_unchanged": """
        from newmsm_tpu_torch.reg import driver
        def _no_step(self, level):
            self.sph_reg = self._project_cpgrid()
        driver.MeshRegistration._evaluate = _no_step
    """,
    "answer_altered": """
        from newmsm_tpu_torch.ops import resample
        _orig = resample.metric_resample
        def _altered(*a, **k):
            out, excl = _orig(*a, **k)
            out.data = out.data + 1e-3
            return out, excl
        resample.metric_resample = _altered
    """,
}


@pytest.mark.parametrize("fault", sorted(SITE))
def test_a_broken_cli_process_is_not_correct(fault, monkeypatch):
    """The CLI cell's subprocesses broken at start-up (a sitecustomize on
    their PYTHONPATH)."""
    site = tempfile.mkdtemp()
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(textwrap.dedent(SITE[fault]))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [site, str(harness.ROOT)] + [os.environ.get("PYTHONPATH", "")]))
    result, lines = run_tiny("strain_cli")
    assert not result["correct"], "\n".join(lines)


# -- the control -----------------------------------------------------------

@pytest.mark.parametrize("name", ["strain_warm", "strain_cli", "gmsm_s4",
                                  "gmsm_s8"])
def test_the_control_fails_the_cells_limits(name, tmp_path):
    """The reference computed a precision lower than the program (TF32
    inputs in float32 for the maps, float32 for the float64 statistics),
    put in the program's place, is not correct under the cell's own
    limits; the program's own outputs are."""
    c = cell(name)
    torch.set_num_threads(2)
    entry = harness.load_module(c.entry_path, c.traffic["entry"]).Entry(
        c, 2 ** 33 + 5, torch.device("cpu"), str(tmp_path), False)
    entry.setup()
    entry.run_unit(0)
    ok, checks = judge.checks(entry.judge(), c.limits)
    assert ok, checks
    own = harness.Cell(harness.load_json(harness.ROOT / "BENCHMARK.json"),
                       TINY_CELLS[name][0]).limits
    ok, checks = judge.checks(entry.judge(control=True), own)
    assert not ok, checks
    entry.peak_bytes()


# -- the optimiser ---------------------------------------------------------

@pytest.mark.parametrize("name,fault", [
    ("strain_warm", "half_alphas"), ("gmsm_s4", "half_alphas"),
    ("gmsm_s4", "half_subjects"), ("gmsm_s4", "bf16_costs")])
def test_a_broken_optimiser_is_not_correct(name, fault):
    """The optimiser's result, held subject by subject to what sound runs
    read (cc_drop, warp_rise), fails with the optimiser broken underneath
    while everything after it stays sound."""
    torch.set_num_threads(2)
    row = calibrate.run_pass(cell(name), fault, 2 ** 33 + 5,
                             torch.device("cpu"), False)
    ok, checks = judge.checks(row["program"], cell(name).limits)
    assert not ok, checks
    assert not (checks["cc_drop"]["ok"] and checks["warp_rise"]["ok"])
    assert checks["resample_off_share"]["ok"], checks


@pytest.mark.parametrize("name", ["strain_warm", "gmsm_s4"])
def test_a_rounding_of_the_inputs_stays_correct(name):
    """Inputs times 1 + 1e-6 N(0,1) (what a change of summation order can
    do inside the program) keep every subject within its band."""
    torch.set_num_threads(2)
    row = calibrate.run_pass(cell(name), "perturb=1", 2 ** 33 + 5,
                             torch.device("cpu"), False)
    ok, checks = judge.checks(row["program"], cell(name).limits)
    assert ok, checks


def test_faults_come_off_again():
    from newmsm_tpu_torch.parallel import group_fusion as GF
    from newmsm_tpu_torch.reg import costs
    from newmsm_tpu_torch.reg.optimise import fusion
    before = (costs.unary_costs, fusion.fusion_binary_solve,
              GF.GroupFusion.alpha_step, GF.GroupFusion.pair_block_cost,
              GF.GroupFusion.__call__)
    for name in sorted(faults.FAULTS):
        faults.install(name)()
    assert before == (costs.unary_costs, fusion.fusion_binary_solve,
                      GF.GroupFusion.alpha_step,
                      GF.GroupFusion.pair_block_cost,
                      GF.GroupFusion.__call__)
