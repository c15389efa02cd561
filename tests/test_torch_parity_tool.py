"""newmsm_tpu_torch.tools.parity on the CPU at a small size: the port's copy
of the scripts/parity_harness.py protocol (typical, msmpair, groupwise on
synth_cohort(3, 4, seed=0), the harness's FAST_* configs at one iteration
a level; the groupwise phase over 2 spawned ranks), its JSON rows, its
comparison with the JAX package's recorded rows, its gates and their exit
code."""
import ast
import json
import pathlib

import pytest

from newmsm_tpu_torch.tools import parity

ROOT = pathlib.Path(__file__).resolve().parents[1]
STATS = {"cc_sulc", "dice_sulc", "cc_curv", "dice_curv", "areal_mean",
         "areal_max", "areal_95", "areal_98", "shape_mean", "shape_max"}


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    """The three phases, the groupwise one over 2 spawned gloo ranks."""
    out = tmp_path_factory.mktemp("parity") / "rows.json"
    rc = parity.main(["--device", "cpu", "--res", "3", "--subjects", "4",
                      "--it", "1", "--fast", "--group-ranks", "2", "--out",
                      str(out)])
    return rc, json.loads(out.read_text())


def test_rows_and_keys(result):
    """Every phase's row has the harness's statistics plus folds, finite
    energies and wall (groupwise: and its rank count, 2); the gates hold
    (rc 0); each row raises cc_sulc."""
    rc, out = result
    assert rc == 0
    assert set(out) == {"fast", "S", "res", "it", "device", "before",
                        "typical", "msmpair", "groupwise"}
    assert (out["S"], out["res"], out["it"], out["fast"]) == (4, 3, 1, True)
    assert set(out["before"]) == STATS
    for phase in parity.PHASES:
        row = out[phase]
        extra = {"folds", "energies_finite", "wall_s"} | (
            {"ranks"} if phase == "groupwise" else set())
        assert set(row) == STATS | extra, phase
        assert row["folds"] == [0] * 4 and row["energies_finite"]
        assert row["cc_sulc"] > out["before"]["cc_sulc"]
    assert out["groupwise"]["ranks"] == 2
    assert parity.gates(out) == []


@pytest.mark.parametrize("recorded", ["parity_fast.json",
                                      "parity_full.json"])
def test_comparison_with_the_recorded_rows(result, recorded):
    """Against the JAX package's files (parity_fast.json: S = 4 at ico-4,
    no msmpair row; parity_full.json: S = 6 at ico-6): said not to be this
    cohort, iterations said to be cut, msmpair compared by pattern only,
    no band verdict on another cohort."""
    _, out = result
    with open(ROOT / recorded) as f:
        ref = json.load(f)
    lines = parity.compare(out, ref)
    assert "not this cohort" in lines[0]
    assert "iterations cut to 1" in lines[1]
    rows = {line.split(":")[0]: line for line in lines[2:]}
    assert set(rows) == {"before", *parity.PHASES} & set(ref)
    if "msmpair" in rows:
        assert "pattern only" in rows["msmpair"]
    assert "OUTSIDE" not in "".join(lines)


def test_a_gap_beyond_the_band_is_flagged(result):
    """On the recorded cohort at full iterations, a typical or groupwise
    cc_sulc more than 0.03 from the JAX package's row is flagged."""
    _, out = result
    with open(ROOT / "parity_full.json") as f:
        ref = json.load(f)
    same = json.loads(json.dumps(out))
    same.update(S=ref["S"], res=ref["res"], fast=ref["fast"], it=None)
    same["typical"]["cc_sulc"] = ref["typical"]["cc_sulc"] + 0.01
    same["groupwise"]["cc_sulc"] = ref["groupwise"]["cc_sulc"] - 0.05
    lines = parity.compare(same, ref)
    flagged = [line.split(":")[0] for line in lines if "OUTSIDE" in line]
    assert flagged == ["groupwise"], lines


@pytest.mark.parametrize("broken", ["folds", "cc", "order", "energy"])
def test_a_broken_gate_exits_non_zero(result, capsys, broken):
    """Each gate, broken in a copy of the rows, makes report() return the
    exit code 1 and print it, and gates() names it; the rows as run give
    0."""
    _, out = result
    bad = json.loads(json.dumps(out))
    if broken == "folds":
        bad["typical"]["folds"][2] = 3
    elif broken == "cc":
        bad["msmpair"]["cc_sulc"] = bad["before"]["cc_sulc"]
    elif broken == "order":
        bad["groupwise"]["cc_sulc"] = bad["typical"]["cc_sulc"] - 1e-3
    else:
        bad["groupwise"]["energies_finite"] = False
    assert len(parity.gates(bad)) == 1
    capsys.readouterr()
    assert parity.report(bad) == 1
    assert "GATE FAILED" in capsys.readouterr().out
    assert parity.report(out) == 0
    assert "gates: all met" in capsys.readouterr().out


def test_imports_nothing_of_the_jax_package():
    """The tool's own imports (the config texts are copies)."""
    tree = ast.parse((ROOT / "newmsm_tpu_torch/tools/parity.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert names and not [n for n in names if n.split(".")[0] in
                          ("jax", "jaxlib", "newmsm_tpu")]
