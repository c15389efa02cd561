"""The tiny version of the multimodal cell `hcp_multimodal_ico6` for the
CPU tests: the same entry, traffic and limits, with ico-3 subjects (10
channels) and the recipe cut to two levels on ico-3 grids, run through
`run.run_cell` on the CPU (the harness's look for a card is skipped)."""
from __future__ import annotations

import copy
import json
import pathlib
import time

import torch

from msmbench import harness, run

CELL = "hcp_multimodal_ico6"
TINY_TRICLIQUE = {
    "simval": "2,2", "sigma_in": "2,1", "sigma_ref": "2,1",
    "lambda": "0.2,0.2", "it": "2,2", "opt": "DISCRETE,DISCRETE",
    "CPgrid": "1,2", "SGgrid": "3,3", "datagrid": "3,3", "regoption": "3",
    "triclique": True, "regexp": "2", "dopt": "HOCR", "VN": True,
    "k_exponent": "2", "bulkmod": "1.6", "shearmod": "0.4"}
# the limits at ico-3 where they cannot be the cell's own: on a grid this
# coarse and a warp this small the optimiser gains less, and many
# registered vertices sit within rounding of a template vertex, where the
# resampling's row choice is a tie
TINY_LIMITS = {"cc_gain": {"min": 0.02}, "resample_off_share": {"max": 0.1},
               "cc_drop": {"max": 0.02}, "warp_rise": {"max": 0.03}}
# per subject, what a sound tiny run reads (made by `python3
# -m msmbench.tests.msmbench_tiny_multimodal` from the root)
BANDS = pathlib.Path(__file__).with_name("tiny_bands_multimodal.json")
SEED = 2 ** 33 + 5


def cell(bands: bool = True):
    """The cell with ico-3 inputs and grids, and a pool of two window
    units."""
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    c = copy.copy(harness.Cell(bench, CELL))
    warm = dict(c.traffic["warmup"], units=0)
    c.traffic = dict(c.traffic, subject_res=3, units=2, warmup=warm)
    c.config = {"options": dict(TINY_TRICLIQUE)}
    c.limits = {k: TINY_LIMITS.get(k, v) for k, v in c.limits.items()}
    c.bands = harness.load_json(BANDS) if bands else {}
    return c


def run_tiny(seed: int = SEED, seconds: float = 0.0, trace: bool = False):
    """One CPU run of the tiny cell; `seconds` 0 runs exactly one unit, a
    long one both. Returns (result, lines)."""
    torch.set_num_threads(2)
    return run.run_cell(cell(), seed, seconds, trace, torch.device("cpu"),
                        time.perf_counter())


def make_bands() -> dict:
    """What a sound tiny run reads, subject by subject, over both units."""
    result, lines = run.run_cell(cell(bands=False), SEED, 1e9, False,
                                 torch.device("cpu"), time.perf_counter())
    info = next(line for line in lines if "reference info " in line)
    scores = json.loads(info.split("reference info ", 1)[1])["subjects"]
    return {sid: {k: float(v) for k, v in s.items()}
            for sid, s in scores.items()}


if __name__ == "__main__":
    torch.set_num_threads(2)
    BANDS.write_text(json.dumps(make_bands(), indent=1) + "\n")
