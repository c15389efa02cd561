"""newmsm_tpu_torch.tools.flagship on the CPU with the fast cut at one
iteration a level: the port's copy of scripts/flagship_recipes.py (the
aMSM longitudinal and HCP multimodal recipes' structures), its rows, its
comparison with flagship_fast.json / flagship_full.json, its gates and
their exit code."""
import ast
import json
import pathlib

import pytest

from newmsm_tpu_torch.tools import flagship

ROOT = pathlib.Path(__file__).resolve().parents[1]
DIST = {"areal_mean", "areal_max", "areal_95", "areal_98", "shape_mean",
        "shape_max"}


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    out = tmp_path_factory.mktemp("flagship") / "rows.json"
    rc = flagship.main(["--device", "cpu", "--fast", "--it", "1", "--out",
                        str(out)])
    return rc, json.loads(out.read_text())


def test_rows_and_keys(result):
    """The script's keys plus folds, finite energies and the iterations run
    a level; the fast cut's sizes (aMSM ico-4, multimodal ico-3, S = 2,
    D = 6); the gates hold (rc 0)."""
    rc, out = result
    assert rc == 0
    assert set(out) == {"fast", "it", "device", "amsm", "multimodal"}
    extra = {"config", "res", "folds", "energies_finite", "iterations"}
    a, m = out["amsm"], out["multimodal"]
    assert set(a) == DIST | extra | {
        "wall_s", "cc_sulc_before", "cc_sulc_after", "anat_radial_cc_before",
        "anat_radial_cc_after", "strain_rows_finite"}
    assert set(m) == DIST | extra | {
        "S", "D", "wall_s_per_subject", "cc_before_mean", "cc_after_mean",
        "cc_after_per_channel", "cc_before_per_channel"}
    assert (a["res"], m["res"], m["S"], m["D"]) == (4, 3, 2, 6)
    assert a["iterations"] == [1, 1, 1]
    assert m["iterations"] == [[1, 1, 1]] * 2
    assert a["folds"] == 0 and m["folds"] == [0, 0]
    assert a["strain_rows_finite"] and a["energies_finite"]
    assert len(m["cc_after_per_channel"]) == 6
    assert flagship.gates(out) == []


def test_the_cohorts_are_the_recorded_ones(result):
    """Before-CCs equal flagship_fast.json's (the JAX rows' inputs, to its 4
    places)."""
    _, out = result
    ref = json.loads((ROOT / "flagship_fast.json").read_text())
    assert round(out["amsm"]["cc_sulc_before"], 4) == \
        ref["amsm"]["cc_sulc_before"]
    assert round(out["amsm"]["anat_radial_cc_before"], 4) == \
        ref["amsm"]["anat_radial_cc_before"]
    assert [round(c, 4) for c in out["multimodal"]["cc_before_per_channel"]] \
        == ref["multimodal"]["cc_before_per_channel"]


@pytest.mark.parametrize("recorded", ["flagship_fast.json",
                                      "flagship_full.json"])
def test_comparison_is_by_pattern_only(result, recorded):
    """Printed beside the JAX rows, said to be pattern only, each row's
    sizes named (the full rows are of ico-6, S = 3, D = 10)."""
    _, out = result
    ref = json.loads((ROOT / recorded).read_text())
    lines = flagship.compare(out, ref)
    assert lines[0].startswith("pattern only: the JAX rows ran the "
                               "reference's config files verbatim")
    assert "iterations cut to 1" in lines[1]
    assert lines[2].startswith("amsm (ico-4; JAX ico-")
    assert lines[3].startswith("multimodal (ico-3, S=2, D=6; JAX ico-")
    assert f"JAX {ref['multimodal']['cc_after_per_channel']}" in lines[4]


@pytest.mark.parametrize("broken", ["amsm_folds", "amsm_cc", "anat_cc",
                                    "strains", "multimodal_folds",
                                    "mean_cc", "channel", "energy"])
def test_a_broken_gate_exits_non_zero(result, capsys, broken):
    """Each gate, broken in a copy of the rows, makes report() return 1 and
    gates() name it; the rows as run give 0."""
    _, out = result
    bad = json.loads(json.dumps(out))
    a, m = bad["amsm"], bad["multimodal"]
    if broken == "amsm_folds":
        a["folds"] = 3
    elif broken == "amsm_cc":
        a["cc_sulc_after"] = a["cc_sulc_before"]
    elif broken == "anat_cc":
        a["anat_radial_cc_after"] = a["anat_radial_cc_before"] - 0.01
    elif broken == "strains":
        a["strain_rows_finite"] = False
    elif broken == "multimodal_folds":
        m["folds"][1] = 1
    elif broken == "mean_cc":
        m["cc_after_mean"] = m["cc_before_mean"]
    elif broken == "channel":
        m["cc_after_per_channel"][4] = m["cc_before_per_channel"][4] - 0.01
    else:
        m["energies_finite"] = False
    assert len(flagship.gates(bad)) == 1, flagship.gates(bad)
    capsys.readouterr()
    assert flagship.report(bad) == 1
    assert "GATE FAILED" in capsys.readouterr().out
    assert flagship.report(out) == 0
    assert "gates: all met" in capsys.readouterr().out


def test_configs_are_the_recipes_structures():
    """Both configs at 10 iterations a level: three discrete levels, CP
    2/3/4, data and SG grids 4/5/6, triclique; aMSM regoption 5 with the
    anatomical grid, multimodal regoption 3 without it. The fast cut and
    --it follow the script's _load_cfg."""
    a, m = flagship.config("amsm"), flagship.config("multimodal")
    for cfg in (a, m):
        assert cfg.iters == [10, 10, 10]
        assert cfg.cpgrid == [2, 3, 4]
        assert cfg.datagrid == cfg.sampgrid == [4, 5, 6]
        assert cfg.triclique
    assert (a.regmode, a.anatgrid) == (5, [4, 5, 6])
    assert m.regmode == 3 and "--anatgrid" not in flagship.MULTIMODAL_CONFIG
    f = flagship.config("amsm", fast=True)
    assert (f.iters, f.cpgrid, f.datagrid, f.sampgrid, f.anatgrid) == (
        [2, 2, 2], [2, 2, 2], [3, 3, 3], [3, 3, 3], [3, 3, 3])
    assert flagship.config("multimodal", fast=True, iters=4).iters == \
        [4, 4, 4]


def test_imports_nothing_of_the_jax_package():
    """The tool's own imports (the config texts are copies)."""
    tree = ast.parse((ROOT / "newmsm_tpu_torch/tools/flagship.py")
                     .read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert names and not [n for n in names if n.split(".")[0] in
                          ("jax", "jaxlib", "newmsm_tpu")]
