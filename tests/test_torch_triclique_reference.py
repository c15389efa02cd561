"""The benchmark's multimodal pieces on the CPU: the frozen multimodal
generator (msmbench/synth_multimodal.py) against the port's
eval/synth.py, the port's triclique likelihood against its plain float64
reference (msmbench/reference/triclique.py), which target data rounded to
bfloat16 fails, the reference's check of the port's face patches, the
likelihood's roofline count, and the imports of the
benchmark's new modules."""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from msmbench import roofline, roofline_triclique
from msmbench import synth_multimodal as SM
from msmbench.reference import triclique as TQ
from msmbench.reference.judge_multimodal import LIK_TOL
from newmsm_tpu_torch.core.mesh import Mesh
from newmsm_tpu_torch.eval import synth as port_synth
from newmsm_tpu_torch.reg import costs as TC
from newmsm_tpu_torch.reg import model as TM

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("n_channels", [3, 10])
def test_frozen_generator_equals_the_ports_multimodal_cohort(n_channels):
    """Subject `sid` of the frozen generator is multimodal_cohort(seed=0)'s
    subject number `sid`: data, template and warp, at ico-3."""
    res, n = 3, 3
    meshes, datasets, template = port_synth.multimodal_cohort(
        res, n, n_channels=n_channels, seed=0)
    coords, faces = SM.icosphere(res)
    np.testing.assert_array_equal(faces, meshes[0].faces)
    np.testing.assert_allclose(coords, meshes[0].coords, rtol=0, atol=1e-9)
    np.testing.assert_allclose(SM.template_data(res, n_channels), template,
                               rtol=0, atol=1e-9)
    unit = coords / SM.RAD
    for sid in range(n):
        np.testing.assert_allclose(SM.subject_data(res, sid, n_channels),
                                   datasets[sid], rtol=0, atol=1e-9)
        np.testing.assert_allclose(
            SM.true_warp(unit, sid),
            port_synth.smooth_sphere_warp(unit, seed=sid, amplitude_deg=9.0),
            rtol=0, atol=1e-12)


def _model(cp_res, res, D, multivariate, seed=0):
    """A triclique model of the port on the CPU at one iteration's state:
    a warped ico-`res` source, the pristine ico-`res` target, D channels
    of seeded random smooth data, random cost-function weights."""
    def sphere(r):
        m = Mesh.from_icosphere(r)
        m.true_rescale(100.0)
        return m
    target, source, control = sphere(res), sphere(res), sphere(cp_res)
    source.coords = port_synth.smooth_sphere_warp(
        source.coords / 100.0, seed + 2, 3.0) * 100.0
    rng = np.random.default_rng(seed)
    unit = target.coords / 100.0
    fs, fr = (np.stack([port_synth._wave_field(unit, rng, 8, 1.5, 4.0)
                        for _ in range(D)]) for _ in range(2))
    cfg = TM.ModelConfig(simval=2, reglambda=0.2, sg_res=res, regmode=3,
                         triclique=True, multivariate=multivariate)
    m = TM.PairwiseModel(cfg, control, source, target, fs, fr, device="cpu")
    s = m.setup_iteration(0.5 + rng.random((1, target.nvertices)))
    T = m.tables.triplets.shape[0]
    la, lb, lc = (torch.from_numpy(rng.integers(0, m.num_labels,
                                                size=(T, 8)))
                  for _ in range(3))
    return m, target, s, (la, lb, lc)


CASES = [(D, mv) for D in (1, 3, 10) for mv in (False, True)
         if not (D == 1 and mv)]


@pytest.mark.parametrize("D,multivariate", CASES)
@pytest.mark.parametrize("cp_res,res", [(1, 3), (2, 4)])
def test_likelihood_matches_the_plain_reference(cp_res, res, D,
                                                multivariate):
    """The port's (T,8) likelihood (float32, K1's CPU twin) against the
    float64 reference on the same inputs: within LIK_TOL (1e-4), the
    judge's tolerance. The entries are similarities in [0, 1] times
    absolute weights near 1; float32 rounding puts the port within ~7e-6
    (a channel vector of near-zero variance at a vertex, D = 3, is the
    worst), so the tolerance has ten times that of room. The same
    comparison with the target data rounded to bfloat16 (the next
    precision down) fails it: its widest gap is 3e-4 or more. D = 1 is
    univariate only: a correlation over one channel is 0 whatever the
    data."""
    m, target, s, (la, lb, lc) = _model(cp_res, res, D, multivariate)

    def port(tables):
        return TC.triclique_likelihood(
            s["cp"], s["rl"], tables, s["face_idx"], s["face_mask"],
            s["src"], s["abs_weights"], s["cfweights"], la, lb, lc, 2,
            multivariate=multivariate)

    ref = TQ.likelihood(s["cp"], s["rl"], m.tables.triplets, s["face_idx"],
                        s["face_mask"], s["src"], s["abs_weights"],
                        s["cfweights"], m.tables.source_data, target.coords,
                        target.faces, m.tables.target_data, la, lb, lc, 2,
                        multivariate)
    assert ref["outside"] == 0 and ref["lik"].dtype == torch.float64
    assert float(ref["lik"].max() - ref["lik"].min()) > 0.1
    gap = (port(m.tables).double() - ref["lik"]).abs()
    assert float(gap.max()) <= LIK_TOL
    bf16 = m.tables._replace(
        target_data=m.tables.target_data.to(torch.bfloat16).float())
    assert float((port(bf16).double() - ref["lik"]).abs().max()) > LIK_TOL


def test_reference_control_is_one_precision_down():
    """The judge's control (float32 from TF32-rounded inputs) moves the
    multivariate likelihood further than LIK_TOL."""
    m, target, s, (la, lb, lc) = _model(1, 3, 10, True)
    args = (s["cp"], s["rl"], m.tables.triplets, s["face_idx"],
            s["face_mask"], s["src"], s["abs_weights"], s["cfweights"],
            m.tables.source_data, target.coords, target.faces,
            m.tables.target_data, la, lb, lc, 2, True)
    ref = TQ.likelihood(*args)["lik"]
    low = TQ.likelihood(*args, prec=TQ.CONTROL)["lik"]
    assert low.dtype == torch.float32
    assert float((low.double() - ref).abs().max()) > LIK_TOL


@pytest.mark.parametrize("deformed", [False, True])
@pytest.mark.parametrize("cp_res,res", [(1, 3), (2, 4), (3, 5)])
def test_the_ports_face_patches_place_every_vertex_once_in_its_triangle(
        cp_res, res, deformed):
    """The face patches the port builds for the likelihood, on the pristine
    CP grid of a level's start and on a deformed one (the search's other
    path): every source vertex in exactly one masked-in slot, of a CP
    triangle that holds it (its least barycentric weight within
    PATCH_TOL)."""
    from newmsm_tpu_torch.ops.nearest import build_tables
    m, _, s, _ = _model(cp_res, res, 1, False)
    cp, (idx, mask) = s["cp"], (s["face_idx"], s["face_mask"])
    if deformed:
        coords = port_synth.smooth_sphere_warp(
            m.cp_grid.coords / 100.0, 7, 2.0) * 100.0
        tables = build_tables(coords, m.cp_grid.faces,
                              m.cp_grid.adjacency[2], "cpu")
        assert tables.pristine_res < 0
        idx, mask, _ = TC.build_face_patches(s["src"], tables, m.fmax)
        cp = torch.as_tensor(coords, dtype=torch.float32)
    f = TQ.patch_faults(cp, m.tables.triplets, idx, mask, s["src"])
    assert f["unplaced"] == 0 and f["outside"] == 0
    assert f["least_weight"] >= -TQ.PATCH_TOL


def _far_face(cp, triplets, point):
    """The CP triangle whose centroid is furthest from `point`."""
    cen = cp[triplets].sum(1)
    return int(torch.argmin(cen @ point))


def _neighbour(triplets, face):
    """A CP triangle that shares an edge with `face`."""
    shared = (triplets[:, :, None] == triplets[face][None, None, :]).any(-1)
    return int(torch.nonzero((shared.sum(1) == 2))[0])


@pytest.mark.parametrize("fault", ["full", "dropped", "twice", "moved",
                                   "neighbour"])
def test_patch_faults_finds_each_fault(fault):
    """patch_faults counts what a full patch drops (the port's own build at
    a capacity below the largest patch), a slot masked off, a vertex kept
    twice, a vertex moved to a far triangle, and a vertex well inside its
    triangle moved to one that shares an edge with it."""
    from newmsm_tpu_torch.ops.nearest import build_tables
    m, _, s, _ = _model(1, 3, 1, False)
    cp, t, src = s["cp"], m.tables.triplets, s["src"]
    idx, mask = s["face_idx"].clone(), s["face_mask"].clone()
    counts = mask.sum(1)
    filled = torch.nonzero(mask)
    t0, p0 = (int(v) for v in filled[0])
    expect = {"unplaced": 0, "outside": 0}
    if fault == "full":
        fmax = int(counts.max()) - 2
        tables = build_tables(m.cp_grid.coords, m.cp_grid.faces,
                              m.cp_grid.adjacency[2], "cpu")
        idx, mask, overflow = TC.build_face_patches(src, tables, fmax)
        assert bool(overflow.any())
        expect["unplaced"] = int((counts - fmax).clamp(min=0).sum())
    elif fault == "dropped":
        mask[t0, p0] = False
        expect["unplaced"] = 1
    else:
        if fault == "neighbour":     # a vertex far from every edge
            w = torch.tensor([TQ.patch_faults(
                cp, t[t0:t0 + 1], idx[t0:t0 + 1, p:p + 1],
                mask[t0:t0 + 1, p:p + 1], src)["least_weight"]
                for p in range(int(counts[t0]))])
            p0 = int(torch.argmax(w))
            assert float(w[p0]) > 0.1
        v = int(idx[t0, p0])
        far = (t0 if fault == "twice"
               else _neighbour(t, t0) if fault == "neighbour"
               else _far_face(cp.double(), t, src[v].double()))
        free = int(counts[far])
        assert free < idx.shape[1]
        idx[far, free], mask[far, free] = v, True
        if fault == "twice":
            expect["unplaced"] = 1
        else:
            mask[t0, p0] = False
            expect["outside"] = 1
    f = TQ.patch_faults(cp, t, idx, mask, src)
    assert {k: f[k] for k in expect} == expect


def test_roofline_count():
    """A valid query's work: K1's, the gather of 3 corners x D float32 and
    the similarity; the least time is the larger bound, linear in the
    queries."""
    assert roofline_triclique.bytes_per_query(10) == \
        roofline.BYTES_PER_QUERY + 120
    assert roofline_triclique.flops_per_query(10, 6) == (
        roofline.flops_per_query(6) + 30 + 60 + 170)
    assert roofline_triclique.flops_per_query(1, 6) == (
        roofline.flops_per_query(6) + 30 + 6 + 16)
    one = roofline_triclique.least_seconds(1000, 10, 6)
    assert one == max(1000 * 148 / roofline.PEAK_BYTES_PER_S,
                      1000 * roofline_triclique.flops_per_query(10, 6)
                      / roofline.PEAK_FP32_FLOPS)
    assert roofline_triclique.least_seconds(2000, 10, 6) == \
        pytest.approx(2 * one)


def test_new_benchmark_modules_import_no_jax_and_the_reference_no_program():
    """The plain reference imports neither JAX, the JAX package nor the
    port; the multimodal judge, generator, roofline count and entry import
    neither JAX nor the JAX package."""
    code = (
        "import json, sys\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "out = {}\n"
        "def loaded():\n"
        "    return sorted({m.split('.')[0] for m in sys.modules\n"
        "                   if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                   'newmsm_tpu', 'newmsm_tpu_torch')})\n"
        "import msmbench.reference.triclique\n"
        "out['reference'] = loaded()\n"
        "import msmbench.reference.judge_multimodal\n"
        "import msmbench.roofline_triclique, msmbench.synth_multimodal\n"
        "from msmbench import harness\n"
        "harness.load_module(harness.HERE / 'entries' /\n"
        "    'register_multimodal.py', 'register_multimodal')\n"
        "out['benchmark'] = loaded()\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                          capture_output=True, text=True, timeout=120,
                          cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["reference"] == []
    assert not set(out["benchmark"]) & {"jax", "jaxlib", "flax",
                                        "newmsm_tpu"}
