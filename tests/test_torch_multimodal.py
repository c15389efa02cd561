"""The HCP multimodal path of newmsm_tpu_torch against the JAX package on
the CPU: the cohorts of the two remaining quality protocols (the hf
matched-CC cohort and the multimodal cohort) are the same arrays in both
packages, and a multimodal_cohort subject with 6 channels goes through
regoption 3 + --triclique (the multivariate triclique likelihood) in both
CLIs to the same quality."""
import numpy as np
import pytest

from newmsm_tpu.eval import synth as JSY
from newmsm_tpu_torch.eval import synth as TSY

from torch_helpers import run_variant_pair


@pytest.mark.parametrize("which", ["hf", "multimodal"])
def test_cohorts_are_equal(which):
    """synth_cohort(3, 4, seed=0, idio_band="hf") and
    multimodal_cohort(3, 2, n_channels=6, seed=0): equal meshes, subject
    data and template data (the same generators, in float64)."""
    if which == "hf":
        def make(mod):
            return mod.synth_cohort(3, 4, seed=0, idio_band="hf")
    else:
        def make(mod):
            return mod.multimodal_cohort(3, 2, n_channels=6, seed=0)
    mj, dj, tj = make(JSY)
    mt, dt, tt = make(TSY)
    assert len(mj) == len(mt) and len(dj) == len(dt)
    for a, b in zip(mj, mt):
        np.testing.assert_array_equal(b.coords, a.coords)
        np.testing.assert_array_equal(b.faces, a.faces)
    for a, b in zip(dj, dt):
        assert b.shape == a.shape == (tj.shape[0], 642)
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(tt, tj)
    assert tj.shape[0] == (2 if which == "hf" else 6)


def test_hf_cohort_differs_from_the_standard_one():
    """idio_band="hf" changes the subjects' data, not the template's."""
    _, d_hf, t_hf = TSY.synth_cohort(3, 2, seed=0, idio_band="hf")
    _, d_sm, t_sm = TSY.synth_cohort(3, 2, seed=0)
    np.testing.assert_array_equal(t_hf, t_sm)
    assert not np.allclose(d_hf[0], d_sm[0])


def test_multimodal_triclique_driver_matches_jax(tmp_path):
    """Two discrete levels (CP ico-1/2, data ico-3, --cprange=1.1) with
    --triclique --VN on 6 channels: fold-free, every channel's CC to the
    template raised, and the mean CC over the channels within 0.01 of the
    JAX run of the same configuration."""
    out = run_variant_pair(tmp_path, "multimodal", cc_tol=0.01)
    assert out["torch"] > out["cc_before"] + 0.1
