"""Tiny versions of the benchmark's cells for the CPU tests: the same
entries, traffic and limits, with ico-3 subjects and configurations cut to
ico-3 grids, run through `run.run_cell` on the CPU (the harness's look for
a card is skipped). `strain_cli` and `gmsm_s4` are the traffic mixes
`cold_cli` and `cohort_s4`, which BENCHMARK.json does not run yet, on the
configurations of strain_warm and gmsm_s8."""
from __future__ import annotations

import copy
import json
import pathlib
import time

import torch

from msmbench import harness, run

TINY_STRAIN = {
    "simval": "2,2,2", "sigma_in": "2,2,2", "sigma_ref": "2,2,2",
    "lambda": "0,0.2,0.2", "it": "3,2,2", "opt": "AFFINE,DISCRETE,DISCRETE",
    "CPgrid": "0,1,2", "SGgrid": "0,3,3", "datagrid": "3,3,3",
    "regoption": "3", "regexp": "2", "dopt": "HOCR", "VN": True,
    "k_exponent": "2", "bulkmod": "1.6", "shearmod": "0.4", "rescaleL": True}
TINY_GROUP = {
    "simval": "2,2", "sigma_in": "0,0", "sigma_ref": "0,0",
    "lambda": "0.2,0.2", "it": "2,2", "opt": "DISCRETE,DISCRETE",
    "CPgrid": "1,2", "SGgrid": "3,3", "datagrid": "3,3", "regoption": "3",
    "regexp": "2", "dopt": "HOCR", "k_exponent": "2", "bulkmod": "1.6",
    "shearmod": "0.4"}
# the limits at ico-3 where they cannot be the cells' own: on a grid this
# coarse and a warp this small the optimiser gains less, and many
# registered vertices sit within rounding of a
# template vertex, where the resampling's row choice is a tie
TINY_LIMITS = {"cc_gain": {"min": 0.02},
               "resample_off_share": {"max": 0.1},
               "maps_off_share": {"max": 0.1}}
# a pairwise ico-3 subject moves further with a change of rounding (0.0064
# CC on one of two subjects) than an ico-6 one; the cohorts keep their own
TINY_PAIR_BANDS = {"cc_drop": {"max": 0.02}, "warp_rise": {"max": 0.03}}
# cell -> (the benchmark cell it is made from, the traffic mix it runs)
TINY_CELLS = {"strain_warm": ("strain_warm", None),
              "strain_cli": ("strain_warm", "cold_cli"),
              "gmsm_s8": ("gmsm_s8", None),
              "gmsm_s4": ("gmsm_s8", "cohort_s4")}
# per subject, what a sound tiny run reads (tiny_bands.json, made by
# `python3 msmbench/tests/msmbench_tiny.py`)
BANDS = pathlib.Path(__file__).with_name("tiny_bands.json")


def cell(name: str, bands: bool = True):
    """The benchmark cell `name` with ico-3 inputs and grids, and a pool of
    two window units."""
    base, mix = TINY_CELLS[name]
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    c = copy.copy(harness.Cell(bench, base))
    c.name = name
    traffic = c.traffic if mix is None else harness.load_json(
        harness.HERE / "traffic" / f"{mix}.json")
    c.entry_path = harness.HERE / "entries" / f"{traffic['entry']}.py"
    warm = dict(traffic["warmup"], units=0)
    c.traffic = dict(traffic, subject_res=3, units=2, warmup=warm)
    group = c.traffic["entry"] == "run_gmsm"
    c.config = {"options": dict(TINY_GROUP if group else TINY_STRAIN)}
    tiny = dict(TINY_LIMITS, **({} if group else TINY_PAIR_BANDS))
    c.limits = {k: tiny.get(k, v) for k, v in c.limits.items()}
    c.bands = harness.load_json(BANDS)[name] if bands else {}
    return c


def run_tiny(name: str, seed: int = 2 ** 33 + 5, seconds: float = 0.0,
             trace: bool = False):
    """One CPU run of the tiny cell; `seconds` 0 runs exactly one unit, a
    long one both. Returns (result, lines)."""
    torch.set_num_threads(2)
    return run.run_cell(cell(name), seed, seconds, trace,
                        torch.device("cpu"), time.perf_counter())


def make_bands() -> dict:
    """What a sound tiny run of each cell reads, subject by subject, over
    every unit the tests run (two)."""
    out = {}
    for name in TINY_CELLS:
        c = cell(name, bands=False)
        result, lines = run.run_cell(c, 2 ** 33 + 5, 1e9, False,
                                     torch.device("cpu"), time.perf_counter())
        info = next(line for line in lines if "reference info " in line)
        scores = json.loads(info.split("reference info ", 1)[1])["subjects"]
        out[name] = {sid: {k: float(v) for k, v in s.items()}
                     for sid, s in scores.items()}
    return out


if __name__ == "__main__":
    torch.set_num_threads(2)
    BANDS.write_text(json.dumps(make_bands(), indent=1) + "\n")
