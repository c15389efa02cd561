"""newmsm_tpu_torch registration pieces (model setup and patches, unary
and triplet costs, the fusion optimiser, rigid alignment) held against the
JAX package on the same seeded state."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from newmsm_tpu.core.mesh import Mesh
from newmsm_tpu.reg import costs as JC
from newmsm_tpu.reg import model as JM
from newmsm_tpu.reg import rigid as JR
from newmsm_tpu.reg.config import RegConfig
from newmsm_tpu.reg.featurespace import Featurespace
from newmsm_tpu.reg.optimise import fusion as JFU

from newmsm_tpu_torch import convert
from newmsm_tpu_torch.ops import icm as ticm
from newmsm_tpu_torch.reg import costs as TC
from newmsm_tpu_torch.reg import model as TM
from newmsm_tpu_torch.reg import rigid as TR
from newmsm_tpu_torch.reg.optimise import fusion as TFU

from fixtures import make_pair, smooth_pattern
from torch_helpers import (assert_close_f32, jax_fusion_starts, np_,
                           warped_icosphere)

RES, CP_RES, SG_RES = 3, 1, 3


def _model_inputs():
    target = Mesh.from_icosphere(RES)
    source = warped_icosphere(RES, seed=2, deg=3.0)
    control = Mesh.from_icosphere(CP_RES)
    feat_src = np.stack([smooth_pattern(target.coords, 1),
                         smooth_pattern(target.coords, 2)])
    feat_ref = np.stack([smooth_pattern(target.coords, 3),
                         smooth_pattern(target.coords, 4)])
    return control, source, target, feat_src, feat_ref


@pytest.fixture(scope="module")
def models():
    control, source, target, fs, fr = _model_inputs()
    kw = dict(simval=2, reglambda=0.2, sg_res=SG_RES, regmode=3,
              rescale_labels=True, multivariate=True)
    jm = JM.PairwiseModel(JM.ModelConfig(**kw), control, source, target,
                          fs, fr)
    tm = TM.PairwiseModel(TM.ModelConfig(**kw), convert.mesh(control),
                          convert.mesh(source), convert.mesh(target),
                          fs, fr, device="cpu")
    cfw = np.ones((1, target.nvertices))
    sj = jm.setup_iteration(cfw)
    st = tm.setup_iteration(cfw)
    return jm, tm, sj, st


def test_model_setup_and_patches_match_jax(models):
    """Same labels, rotations, pmax and tables; per-CP patch SETS equal
    (top_k orders ties differently), overflow equal."""
    jm, tm, sj, st = models
    assert tm.num_labels == jm.num_labels
    assert tm.pmax == jm.pmax
    L = tm.num_labels
    np.testing.assert_allclose(np_(st["labels"]), np_(sj["labels"])[:L],
                               atol=1e-5)
    np.testing.assert_allclose(np_(st["rl"]), np_(sj["rl"])[:, :L], atol=1e-4)
    np.testing.assert_array_equal(np_(tm.tables.triplets),
                                  np_(jm.tables.triplets))
    np.testing.assert_allclose(np_(tm.tables.maxsep), np_(jm.tables.maxsep),
                               rtol=1e-6)
    pj, mj = np_(sj["patch_idx"]), np_(sj["patch_mask"])
    pt, mt = np_(st["patch_idx"]), np_(st["patch_mask"])
    for k in range(pj.shape[0]):
        assert set(pt[k][mt[k]]) == set(pj[k][mj[k]]), k


@pytest.mark.parametrize("cp_res,src_res,deg", [(1, 3, 3.0), (2, 4, 1.0)])
def test_build_patches_matches_jax(cp_res, src_res, deg):
    """Dense path (ico-1 CPs on ico-3, where no ball is certified) and the
    certified-ball path (ico-2 CPs on a mildly warped ico-4): equal
    candidate balls, equal overflow flags, equal patch sets for every CP
    that does not overflow."""
    control = Mesh.from_icosphere(cp_res)
    source = warped_icosphere(src_res, seed=2, deg=deg)
    cp = control.coords.astype(np.float32)
    src = source.coords.astype(np.float32)
    maxsep = control.max_vertex_distances().astype(np.float32)
    ball = JC.patch_candidate_ball(cp, src, source.faces, maxsep)
    ball_t = TC.patch_candidate_ball(cp, src, source.faces, maxsep,
                                     device="cpu")
    assert (ball is None) == (src_res == 3)
    if ball is not None:
        np.testing.assert_array_equal(ball_t, ball)
    pfull = JC.max_inrange_count(cp, src, maxsep)
    assert TC.max_inrange_count(cp, src, maxsep, device="cpu") == pfull
    for pmax in (16, pfull + 8):      # 16 overflows: the grow signal
        ij, mj, oj = JC.build_patches(
            jnp.asarray(cp), jnp.asarray(src), jnp.asarray(maxsep), 1.0,
            pmax, None if ball is None else jnp.asarray(ball))
        it, mt, ot = TC.build_patches(
            torch.from_numpy(cp), torch.from_numpy(src),
            torch.from_numpy(maxsep), 1.0, pmax,
            None if ball is None else torch.from_numpy(ball.astype(np.int64)))
        np.testing.assert_array_equal(np_(ot), np_(oj))
        assert np_(oj).any() == (pmax == 16)
        for k in range(cp.shape[0]):
            if not np_(oj)[k]:
                assert (set(np_(it)[k][np_(mt)[k]])
                        == set(np_(ij)[k][np_(mj)[k]])), (pmax, k)


@pytest.mark.parametrize("mode", ["univariate", "multivariate"])
def test_unary_costs_match_jax(models, mode):
    """The (K,L) unary volume from identical state: atol 1e-4 (weighted
    correlations of float32 resampled data, values in [0, 1])."""
    jm, _, sj, _ = models
    st = convert.iteration_state({k: np.asarray(v) for k, v in sj.items()},
                                 device="cpu")
    lt = convert.level_tables(jm.tables, device="cpu")
    src_j, src_t = jm.tables.source_data, lt.source_data
    if mode == "univariate":
        src_j, src_t = src_j[:1], src_t[:1]
    uj = JC.unary_costs(sj["cp"], sj["rl"], sj["src"], sj["patch_idx"],
                        sj["patch_mask"], jm.tables.target_tables, src_j,
                        jm.tables.target_data[:src_j.shape[0]],
                        sj["cfweights"], sj["abs_weights"], 2, mode=mode)
    ut = TC.unary_costs(st["cp"], st["rl"], st["src"], st["patch_idx"],
                        st["patch_mask"], lt.target_tables, src_t,
                        lt.target_data[:src_t.shape[0]], st["cfweights"],
                        st["abs_weights"], 2, mode=mode)
    assert ut.shape == uj.shape
    np.testing.assert_allclose(np_(ut), np_(uj), atol=1e-4, rtol=0)


def test_triplet_costs_match_jax(models):
    """triplet_combo_costs and the binary_fast (T,8) tables: float32 strain
    costs (see assert_close_f32), FOLDING entries equal."""
    jm, tm, sj, _ = models
    st = convert.iteration_state({k: np.asarray(v) for k, v in sj.items()},
                                 device="cpu")
    tm.tables = convert.level_tables(jm.tables, device="cpu")
    T = jm.tables.triplets.shape[0]
    L = jm.num_labels
    rng = np.random.default_rng(0)
    la, lb, lc = (rng.integers(0, L, size=(T, 6)) for _ in range(3))
    args = (0.2, 0.4, 1.6, 2.0, 2.0)
    cj = JC.triplet_combo_costs(sj["rl"], sj["cp"], jm.tables, jnp.asarray(la),
                                jnp.asarray(lb), jnp.asarray(lc), *args)
    ct = TC.triplet_combo_costs(st["rl"], st["cp"], tm.tables,
                                torch.from_numpy(la), torch.from_numpy(lb),
                                torch.from_numpy(lc), *args)
    st64 = {k: (v.double() if v.is_floating_point() else v)
            for k, v in st.items()}
    t64 = tm.tables._replace(orig_cp=tm.tables.orig_cp.double())
    c64 = TC.triplet_combo_costs(st64["rl"], st64["cp"], t64,
                                 torch.from_numpy(la), torch.from_numpy(lb),
                                 torch.from_numpy(lc), *args)
    assert_close_f32(ct, cj, c64)

    cur = rng.integers(0, L, size=(T, 3))
    fj = jm.triplet_combo_fn(sj).binary_fast(jnp.asarray(cur, jnp.int32), 3)
    ft = tm.triplet_combo_fn(st).binary_fast(torch.from_numpy(cur), 3)
    f64 = tm.triplet_combo_fn(st64).binary_fast(torch.from_numpy(cur), 3)
    assert_close_f32(ft, fj, f64)


def test_fusion_optimize_matches_jax_with_injected_starts(models):
    """Same unary, tables and random starts: the same labeling, energy to
    rtol 1e-5."""
    jm, tm, sj, _ = models
    st = convert.iteration_state({k: np.asarray(v) for k, v in sj.items()},
                                 device="cpu")
    tm.tables = convert.level_tables(jm.tables, device="cpu")
    L = jm.num_labels
    uj = jm.unary(sj).T[:L]                              # (L,K)
    K = uj.shape[1]
    tfn_j = jm.triplet_combo_fn(sj)
    lab_j = JFU.fusion_optimize(jnp.zeros(K, jnp.int32), uj,
                                jm.tables.triplets, jm.fusion_tables, tfn_j,
                                jnp.int32(L))
    e_j = float(JFU.fusion_energy(lab_j, uj, jm.tables.triplets, tfn_j))

    ut = torch.from_numpy(np.array(uj))
    tfn_t = tm.triplet_combo_fn(st)
    ftab = convert.fusion_tables(jm.fusion_tables, device="cpu")
    lab_t = TFU.fusion_optimize(torch.zeros(K, dtype=torch.int64), ut,
                                tm.tables.triplets, ftab, tfn_t, L,
                                random_starts=jax_fusion_starts(K))
    e_t = float(TFU.fusion_energy(lab_t, ut, tm.tables.triplets, tfn_t))
    np.testing.assert_array_equal(np_(lab_t), np_(lab_j))
    np.testing.assert_allclose(e_t, e_j, rtol=1e-5)
    assert (np_(lab_t) != 0).any()

    # the port's own tables and a seeded generator: a valid descent too
    lab_g = TFU.fusion_optimize(torch.zeros(K, dtype=torch.int64), ut,
                                tm.tables.triplets, tm.fusion_tables, tfn_t,
                                L, generator=torch.Generator().manual_seed(7))
    e_0 = float(TFU.fusion_energy(torch.zeros(K, dtype=torch.int64), ut,
                                  tm.tables.triplets, tfn_t))
    assert float(TFU.fusion_energy(lab_g, ut, tm.tables.triplets,
                                   tfn_t)) <= e_0


def _all_states(K):
    n = 1 << K
    return torch.from_numpy(
        ((np.arange(n)[:, None] >> np.arange(K)[None, :]) & 1).astype(np.int64))


def test_fusion_binary_solve_is_exact_on_12_nodes():
    """Every binary move of a 12-CP problem (unary data volume + strain
    triplets) solved by the port equals the 4096-state enumeration minimum
    (float32 sums: rtol 1e-6), as tests/test_fusion_optimality.py asserts
    for the JAX package."""
    target = convert.mesh(Mesh.from_icosphere(3))
    control = convert.mesh(Mesh.from_icosphere(0))
    fs = smooth_pattern(target.coords, 3)[None]
    fr = smooth_pattern(target.coords, 4)[None]
    tm = TM.PairwiseModel(TM.ModelConfig(simval=2, reglambda=0.3, sg_res=2,
                                         regmode=3), control, target, target,
                          fs, fr, device="cpu")
    s = tm.setup_iteration(np.ones((1, target.nvertices)))
    unary = tm.unary(s).T
    K, L = control.nvertices, tm.num_labels
    assert K == 12 and L > 2
    tfn = tm.triplet_combo_fn(s)
    trip = tm.tables.triplets
    gen = torch.Generator().manual_seed(0)
    X = _all_states(K)
    labeling = torch.zeros(K, dtype=torch.int64)
    for alpha in list(range(1, L)) + list(range(L)):
        u0, u1, t8, _ = TFU.binary_move_tables(labeling, alpha, unary, trip, tfn)
        x = TFU.fusion_binary_solve(labeling, alpha, unary, trip,
                                    tm.fusion_tables, tfn,
                                    starts=torch.randint(0, 2, (2, K),
                                                         generator=gen))
        e = float(ticm.binary_energy(x, u0, u1, t8, trip))
        e_min = float(ticm.binary_energy(X, u0, u1, t8, trip).min())
        assert e == pytest.approx(e_min, rel=1e-6, abs=1e-6), alpha
        labeling = torch.where(x == 1, torch.full_like(labeling, alpha),
                               labeling)


def test_rigid_align_matches_jax():
    """Rigid alignment of a 10-degree rotated pair: the final cost to rtol
    1e-4, coordinates to 1e-2 at RAD = 100 (float32 cost sums in another
    order shift the finite-difference gradients slightly)."""
    inp, ind, ref, refd = make_pair(res=3, rot_degrees=10.0, seed=2)
    feat = Featurespace(data=[ind, refd], excl=[None, None])
    cfg = RegConfig()
    out_j = JR.rigid_align(inp, ref, feat, cfg, iters=10, simval=2)
    out_t = TR.rigid_align(convert.mesh(inp), convert.mesh(ref), feat, cfg,
                           iters=10, simval=2, device="cpu")
    np.testing.assert_allclose(out_t.coords, out_j.coords, atol=1e-2)

    mvd = inp.calculate_MeanVD()
    cos_ang = float(np.cos(2 * np.arcsin(4 * mvd / 200.0)))
    src_c = torch.from_numpy(TR._center_columns(ind).astype(np.float32))
    tgt_c = torch.from_numpy(TR._center_columns(refd).astype(np.float32))
    tgt = torch.from_numpy(ref.coords.astype(np.float32))
    z = torch.zeros(3)

    def cost(mesh):
        return float(TR.rigid_cost(z, torch.from_numpy(
            mesh.coords.astype(np.float32)), src_c, tgt, tgt_c, cos_ang,
            mvd, 2))

    c_j = float(JR.rigid_cost(jnp.zeros(3), jnp.asarray(out_j.coords,
                                                        jnp.float32),
                              jnp.asarray(src_c.numpy()), jnp.asarray(
                                  tgt.numpy()), jnp.asarray(tgt_c.numpy()),
                              cos_ang, mvd, 2))
    np.testing.assert_allclose(cost(out_j), c_j, rtol=1e-5)
    np.testing.assert_allclose(cost(out_t), cost(out_j), rtol=1e-4)
    assert cost(out_t) > cost(inp)
