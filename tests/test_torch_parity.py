"""The registration-quality gates of tests/test_parity.py on the port:
the 4-subject typical gate (pairwise config_standard_MSM_strain structure
at ico-3) and the MSMpair (regoption 1) lambda-response gate, run on
newmsm_tpu_torch's MeshRegistration(device="cpu") and scored with the
port's eval.metrics. Same cohort, configurations and thresholds as the JAX
package's gates."""
import json

import numpy as np
import pytest

from newmsm_tpu_torch.eval import metrics
from newmsm_tpu_torch.eval.synth import synth_cohort
from newmsm_tpu_torch.ops.unfold import count_folds
from newmsm_tpu_torch.reg.config import RegConfig
from newmsm_tpu_torch.reg.driver import MeshRegistration

S, RES = 4, 3


@pytest.fixture(scope="module")
def cohort():
    meshes, datasets, template_data = synth_cohort(RES, S, seed=0,
                                                   warp_deg=6.0)
    return meshes, datasets, template_data


def channel_stats(maps):
    out = {}
    for d, name in enumerate(("sulc", "curv")):
        ch = [m[d] for m in maps]
        out[f"cc_{name}"] = metrics.mean_pairwise_cc(ch)
        out[f"dice_{name}"] = metrics.mean_pairwise_dice(ch)
    return out


def _config(regmode, reglambda):
    # config_standard_MSM_strain structure at ico-3 scale
    cfg = RegConfig()
    cfg.cost = ["AFFINE", "DISCRETE", "DISCRETE"]
    cfg.simval = [2, 2, 2]
    cfg.iters = [10, 3, 3]
    cfg.sigma_in = [2.0, 2.0, 1.0]
    cfg.sigma_ref = [2.0, 2.0, 1.0]
    cfg.reglambda = reglambda
    cfg.datagrid = [3, 3, 3]
    cfg.cpgrid = [0, 1, 2]
    cfg.sampgrid = [0, 3, 4]
    cfg.anatgrid = [3, 3, 3]
    cfg.mciters = [0, 0, 0]
    cfg.dopt = "HOCR"
    cfg.regmode = regmode
    return cfg


def _register(mesh, data, template_data, cfg, prefix, metrics_path=None):
    mr = MeshRegistration(device="cpu")
    mr.set_input(mesh.copy())
    mr.set_reference(mesh.copy())
    mr.set_input_data(data)
    mr.set_reference_data(template_data)
    mr.outdir = prefix
    mr.metrics_path = metrics_path
    mr.run_multiresolutions(cfg)
    return mr


def test_typical_thresholds_hold_on_the_port(cohort, tmp_path):
    """The typical half of test_parity's quality gate: cc_sulc >= 0.69 and
    at least 0.03 above the unregistered cohort, dice_sulc >= 0.57, mean
    |log2 areal| <= 0.30, fold-free warps."""
    meshes, datasets, template_data = cohort
    before = channel_stats(datasets)
    cfg = _config(3, [0.0, 0.2, 0.2])
    cfg.variance_norm = True
    maps, dists = [], []
    for s in range(S):
        mr = _register(meshes[s], datasets[s], template_data, cfg,
                       str(tmp_path / f"t{s}."))
        maps.append(np.asarray(mr.transformed_data))
        dists.append(metrics.distortion_stats(*metrics.distortion_maps(
            mr.in_mesh, mr.warped_input)))
        assert count_folds(mr.warped_input, device="cpu") == 0
    typical = channel_stats(maps)
    assert typical["cc_sulc"] > before["cc_sulc"] + 0.03, (before, typical)
    assert typical["cc_sulc"] >= 0.69, typical
    assert typical["dice_sulc"] >= 0.57, typical
    t_areal = np.mean([d["areal_mean"] for d in dists])
    assert t_areal <= 0.30, t_areal


def test_msmpair_lambda_response_and_gate_hold_on_the_port(cohort, tmp_path):
    """The MSMpair (regoption 1) gate: distortion strictly decreasing over
    a 10x raise of lambda, the chosen labeling NEVER on a FOLDING-gated
    entry, and the lambda x3 distortion within ~2x of the strain-typical
    level with CC above 0.60."""
    meshes, datasets, template_data = cohort

    def run(lmult, tag):
        path = str(tmp_path / f"p{tag}.jsonl")
        mr = _register(meshes[0], datasets[0], template_data,
                       _config(1, [0.0, 0.1 * lmult, 0.2 * lmult]),
                       str(tmp_path / f"p{tag}."), path)
        d = metrics.distortion_stats(*metrics.distortion_maps(
            mr.in_mesh, mr.warped_input))
        gates = [ev for ev in map(json.loads, open(path))
                 if ev.get("event") == "fold_gate"]
        assert len(gates) == 6
        cc = metrics.cross_correlation(mr.transformed_data[0],
                                       template_data[0])
        return (d["areal_mean"], sum(ev["chosen_gated"] for ev in gates),
                float(cc))

    a1, g1, _ = run(1.0, "x1")
    a10, g10, _ = run(10.0, "x10")
    assert g1 == 0 and g10 == 0, (g1, g10)
    assert a10 < a1, (a1, a10)              # lambda bites at this scale
    a3, g3, cc3 = run(3.0, "x3")
    assert g3 == 0
    assert a3 <= 0.30, (a1, a3, a10)
    assert cc3 > 0.60, cc3
