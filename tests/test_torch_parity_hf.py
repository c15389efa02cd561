"""newmsm_tpu_torch.tools.parity on the hf cohort, on the CPU at a small
size: the port's copy of the scripts/group_full_diag.py matched-CC protocol
(synth_cohort(3, 4, seed=0, idio_band="hf"), hf typical and hf groupwise at
lambda 0.3 / 0.8 / 1.2, the harness's FAST_* configs at one iteration a
level), its rows, its comparison with group_full_diag.json, the gates of
tests/test_parity_full_nightly.py and their exit code; and the lam row on
the standard cohort."""
import json
import pathlib

import pytest

from newmsm_tpu_torch.tools import parity

ROOT = pathlib.Path(__file__).resolve().parents[1]
STATS = {"cc_sulc", "dice_sulc", "cc_curv", "dice_curv", "areal_mean",
         "areal_max", "areal_95", "areal_98", "shape_mean", "shape_max"}
SMALL = ["--device", "cpu", "--res", "3", "--subjects", "4", "--it", "1",
         "--fast"]


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    out = tmp_path_factory.mktemp("parity_hf") / "rows.json"
    rc = parity.main([*SMALL, "--cohort", "hf", "--phases", "hf", "--out",
                      str(out)])
    return rc, json.loads(out.read_text())


def test_rows_and_keys(result):
    """hf_before, hf_typical and one groupwise row a lambda, each with the
    harness's statistics plus folds, finite energies and wall; the groupwise
    rows their rank count and ratio_vs_typical (areal_mean over
    hf_typical's, 3 places); the gates hold (rc 0)."""
    rc, out = result
    assert rc == 0
    assert set(out) == {"fast", "S", "res", "it", "device", "hf_before",
                        *parity.HF_ROWS}
    assert parity.HF_ROWS == ("hf_typical", "hf_groupwise_lam0.3",
                              "hf_groupwise_lam0.8", "hf_groupwise_lam1.2")
    assert set(out["hf_before"]) == STATS
    for name in parity.HF_ROWS:
        row = out[name]
        extra = {"folds", "energies_finite", "wall_s"}
        if name != "hf_typical":
            extra |= {"ranks", "ratio_vs_typical"}
            assert row["ratio_vs_typical"] == round(
                row["areal_mean"] / out["hf_typical"]["areal_mean"], 3)
        assert set(row) == STATS | extra, name
        assert row["folds"] == [0] * 4 and row["energies_finite"]
        assert row["cc_sulc"] > out["hf_before"]["cc_sulc"]
    assert parity.gates(out) == []


def test_the_hf_cohort_is_the_recorded_one_at_its_size():
    """The tool's hf_before row at S = 6 ico-6 is group_full_diag.json's
    (the same cohort as the JAX rows)."""
    from newmsm_tpu_torch.eval.synth import synth_cohort
    ref = json.loads((ROOT / "group_full_diag.json").read_text())
    _, datasets, _ = synth_cohort(6, 6, seed=0, idio_band="hf")
    got = parity.channel_stats(datasets)
    for key, want in ref["hf_before"].items():
        assert got[key] == pytest.approx(want, rel=1e-9), key


def test_comparison_with_group_full_diag(result):
    """Against group_full_diag.json (S = 6 at ico-6, full iterations): said
    not to be this cohort, iterations said to be cut, each hf row beside
    the JAX one with ratio_vs_typical beside the JAX ratio, no band verdict
    on another cohort."""
    _, out = result
    ref = json.loads((ROOT / "group_full_diag.json").read_text())
    lines = parity.compare(out, ref, ("hf_before",) + parity.HF_ROWS)
    assert "not this cohort" in lines[0]
    assert "iterations cut to 1" in lines[1]
    rows = {line.split(":")[0]: line for line in lines[2:]}
    assert set(rows) == {"hf_before", *parity.HF_ROWS}
    assert "ratio_vs_typical port" in rows["hf_groupwise_lam1.2"]
    assert "JAX 1.638" in rows["hf_groupwise_lam1.2"]
    assert "OUTSIDE" not in "".join(lines)


def test_a_gap_beyond_the_band_is_flagged(result):
    """On the recorded cohort at full iterations, an hf row whose cc_sulc is
    more than 0.03 from group_full_diag.json's is flagged, and only it."""
    _, out = result
    ref = json.loads((ROOT / "group_full_diag.json").read_text())
    same = json.loads(json.dumps(out))
    same.update(S=ref["S"], res=ref["res"], fast=ref["fast"], it=None)
    for name in parity.HF_ROWS:
        same[name]["cc_sulc"] = ref[name]["cc_sulc"] + 0.02
    same["hf_groupwise_lam0.8"]["cc_sulc"] = \
        ref["hf_groupwise_lam0.8"]["cc_sulc"] - 0.04
    lines = parity.compare(same, ref, ("hf_before",) + parity.HF_ROWS)
    flagged = [line.split(":")[0] for line in lines if "OUTSIDE" in line]
    assert flagged == ["hf_groupwise_lam0.8"], lines


@pytest.mark.parametrize("broken", ["cc_sulc", "cc_curv", "ratio", "folds",
                                    "energy"])
def test_a_broken_gate_exits_non_zero(result, capsys, broken):
    """Each gate of the hf rows (the nightly's three at lambda 1.2: cc_sulc
    and cc_curv >= hf_typical's, ratio_vs_typical <= 1.75; 0 folds and
    finite energies on every row), broken in a copy of the rows, makes
    report() return 1 and gates() name it; the rows as run give 0."""
    _, out = result
    bad = json.loads(json.dumps(out))
    gw, ty = bad["hf_groupwise_lam1.2"], bad["hf_typical"]
    if broken in ("cc_sulc", "cc_curv"):
        gw[broken] = ty[broken] - 1e-3
    elif broken == "ratio":
        gw["ratio_vs_typical"] = 1.751
    elif broken == "folds":
        bad["hf_groupwise_lam0.3"]["folds"][1] = 2
    else:
        ty["energies_finite"] = False
    assert len(parity.gates(bad)) == 1, parity.gates(bad)
    capsys.readouterr()
    assert parity.report(bad) == 1
    assert "GATE FAILED" in capsys.readouterr().out
    assert parity.report(out) == 0
    assert "gates: all met" in capsys.readouterr().out


def test_phases_are_checked_against_the_cohort():
    """hf runs only on the hf cohort, the standard phases only on the
    standard one: argparse refuses the others (exit code 2)."""
    for args in (["--phases", "hf"], ["--cohort", "hf", "--phases",
                                      "typical"]):
        with pytest.raises(SystemExit) as e:
            parity.main([*SMALL, *args])
        assert e.value.code == 2


def test_lam_row_is_printed_not_compared(tmp_path, capsys):
    """The lam phase on the standard cohort: row groupwise_lam0.5 with the
    groupwise keys, gates met, printed as not compared."""
    out = tmp_path / "lam.json"
    rc = parity.main([*SMALL, "--subjects", "2", "--phases", "lam", "--out",
                      str(out)])
    rows = json.loads(out.read_text())
    assert rc == 0
    assert set(rows) == {"fast", "S", "res", "it", "device", "before",
                         "groupwise_lam0.5"}
    assert set(rows["groupwise_lam0.5"]) == STATS | {
        "folds", "energies_finite", "wall_s", "ranks"}
    assert "groupwise_lam0.5: cc_sulc" in capsys.readouterr().out


def test_lambda_is_set_on_every_level():
    cfg = parity.config("groupwise", fast=True, lam=1.2)
    assert cfg.reglambda == [1.2, 1.2, 1.2]
    assert parity.config("groupwise").reglambda == [0.3, 0.3, 0.3]
    with pytest.raises(ValueError):
        parity.config("typical", lam=0.5)
