"""Full-scale matched-CC gate of newmsm_tpu_torch on a card: the port's
twin of tests/test_parity_full_nightly.py.

It runs `python -m newmsm_tpu_torch.tools.parity --cohort hf --phases hf`
(S = 6, ico-6, the configs' full iterations, the port's copy of
scripts/group_full_diag.py's protocol) and holds its lambda = 1.2 row to
the nightly's gates: groupwise cc_sulc and cc_curv at least hf typical's,
at an areal distortion ratio to typical of at most 1.75 (the JAX package's
row: 1.638, group_full_diag.json). It writes its rows under the test's
temporary directory, never group_full_diag.json.

Minutes on the card, so it runs only with NEWMSM_NIGHTLY=1 and a CUDA
card; it imports neither JAX nor the JAX package, so it runs on the
card's machine:

    NEWMSM_NIGHTLY=1 python -m pytest -m cuda --noconftest -q \\
        tests/test_torch_parity_full_nightly.py
"""
import json
import os
import subprocess
import sys

import pytest
import torch

nightly = pytest.mark.skipif(
    os.environ.get("NEWMSM_NIGHTLY", "") != "1",
    reason="full-scale parity run; set NEWMSM_NIGHTLY=1 to run")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@nightly
@pytest.mark.cuda
def test_hf_matched_cc_ratio_full_scale(cuda, tmp_path):
    out_json = tmp_path / "hf.json"
    r = subprocess.run(
        [sys.executable, "-m", "newmsm_tpu_torch.tools.parity", "--cohort",
         "hf", "--phases", "hf", "--device", str(cuda), "--out",
         str(out_json)], cwd=ROOT, capture_output=True, text=True,
        timeout=3 * 3600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    d = json.loads(out_json.read_text())
    assert (d["S"], d["res"], d["fast"], d["it"]) == (6, 6, False, None)
    ty = d["hf_typical"]
    gw = d["hf_groupwise_lam1.2"]
    # matched-CC: groupwise still equal-or-better on CC...
    assert gw["cc_sulc"] >= ty["cc_sulc"], (gw["cc_sulc"], ty["cc_sulc"])
    assert gw["cc_curv"] >= ty["cc_curv"], (gw["cc_curv"], ty["cc_curv"])
    # ...at the full-scale distortion bound
    assert gw["ratio_vs_typical"] <= 1.75, gw["ratio_vs_typical"]
