"""Whole-driver runs of the port's patchwise and triclique data terms
against the JAX package, through both CLIs on the same GIFTI files (the
regoption 1, MCMC and regoption 5 runs sit beside their modules' tests in
test_torch_costs_variants.py, test_torch_mcmc.py and test_torch_amsm.py)."""
import pytest

from torch_helpers import run_variant_pair


@pytest.mark.parametrize("which", ["patchwise", "triclique"])
def test_variant_driver_matches_jax(tmp_path, which):
    """Regoption 3 with --patchwise (AFFINE + two discrete levels at ico-3,
    CP 1/2, on a warped cohort subject) or --triclique (one level, CP 2, on
    a 10-degree rotated pair): fold-free, CC above the before-CC, and
    within 0.01 CC of the JAX run of the same configuration."""
    run_variant_pair(tmp_path, which, cc_tol=0.01)
