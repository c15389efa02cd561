"""newmsm_tpu_torch cost variants (patchwise unary, the MCMC triplet
volume, the pairwise rotation regulariser, face patches and the triclique
likelihood, face colouring, the fusion pair path) held against the JAX
package on the same seeded state, and the whole regoption-1 driver run."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from newmsm_tpu.core.mesh import Mesh
from newmsm_tpu.ops.nearest import build_tables as j_build_tables
from newmsm_tpu.reg import costs as JC
from newmsm_tpu.reg import model as JM
from newmsm_tpu.reg.optimise import coloring as JCOL
from newmsm_tpu.reg.optimise import fusion as JFU

from newmsm_tpu_torch import convert
from newmsm_tpu_torch.ops import icm as ticm
from newmsm_tpu_torch.ops.nearest import build_tables as t_build_tables
from newmsm_tpu_torch.reg import costs as TC
from newmsm_tpu_torch.reg import model as TM
from newmsm_tpu_torch.reg.optimise import coloring as TCOL
from newmsm_tpu_torch.reg.optimise import fusion as TFU

from fixtures import smooth_pattern
from torch_helpers import (assert_close_f32, jax_fusion_starts, np_,
                           run_variant_pair, warped_icosphere)

RES, CP_RES, SG_RES = 3, 1, 3
STRAIN = (0.2, 0.4, 1.6, 2.0, 2.0)      # lambda, mu, kappa, k_exp, rexp


def _inputs():
    target = Mesh.from_icosphere(RES)
    source = warped_icosphere(RES, seed=2, deg=3.0)
    control = Mesh.from_icosphere(CP_RES)
    feat_src = np.stack([smooth_pattern(target.coords, 1),
                         smooth_pattern(target.coords, 2)])
    feat_ref = np.stack([smooth_pattern(target.coords, 3),
                         smooth_pattern(target.coords, 4)])
    return control, source, target, feat_src, feat_ref


def _models(**kw):
    """The JAX model, the port's model, and one iteration's state of the
    JAX model carried into the port (identical inputs for both)."""
    control, source, target, fs, fr = _inputs()
    kw = dict(dict(simval=2, reglambda=0.2, sg_res=SG_RES, regmode=3,
                   multivariate=True), **kw)
    jm = JM.PairwiseModel(JM.ModelConfig(bucket_labels=False, **kw), control,
                          source, target, fs, fr)
    tm = TM.PairwiseModel(TM.ModelConfig(**kw), convert.mesh(control),
                          convert.mesh(source), convert.mesh(target),
                          fs, fr, device="cpu")
    cfw = np.ones((1, target.nvertices))
    sj = jm.setup_iteration(cfw)
    tm.setup_iteration(cfw)
    st = convert.iteration_state({k: np.asarray(v) for k, v in sj.items()},
                                 device="cpu")
    tm.tables = convert.level_tables(jm.tables, device="cpu")
    return jm, tm, sj, st


@pytest.fixture(scope="module")
def strain_models():
    return _models()


@pytest.fixture(scope="module")
def pair_models():
    return _models(regmode=1)


@pytest.fixture(scope="module")
def triclique_models():
    return _models(triclique=True)


def test_patchwise_unary_matches_jax(strain_models):
    """The (K,L) patchwise unary volume (mean over channels of per-channel
    patch correlations) from identical state: atol 1e-4."""
    jm, tm, sj, st = strain_models
    uj = JC.unary_costs(sj["cp"], sj["rl"], sj["src"], sj["patch_idx"],
                        sj["patch_mask"], jm.tables.target_tables,
                        jm.tables.source_data, jm.tables.target_data,
                        sj["cfweights"], sj["abs_weights"], 2,
                        mode="patchwise")
    ut = TC.unary_costs(st["cp"], st["rl"], st["src"], st["patch_idx"],
                        st["patch_mask"], tm.tables.target_tables,
                        tm.tables.source_data, tm.tables.target_data,
                        st["cfweights"], st["abs_weights"], 2,
                        mode="patchwise")
    assert ut.shape == uj.shape
    np.testing.assert_allclose(np_(ut), np_(uj), atol=1e-4, rtol=0)
    with pytest.raises(ValueError):
        TC.unary_costs(st["cp"], st["rl"], st["src"], st["patch_idx"],
                       st["patch_mask"], tm.tables.target_tables,
                       tm.tables.source_data, tm.tables.target_data,
                       st["cfweights"], st["abs_weights"], 2, mode="nope")


@pytest.mark.parametrize("tchunk", [256, 7])
def test_triplet_cost_volume_matches_jax(strain_models, tchunk):
    """The (T,L,L,L) MCMC strain volume: float32 strain costs to rtol 2e-4
    (see assert_close_f32), equal FOLDING entries; the chunk size does not
    change it."""
    jm, tm, sj, st = strain_models
    vj = JC.triplet_cost_volume(sj["rl"], sj["cp"], jm.tables, *STRAIN)
    vt = TC.triplet_cost_volume(st["rl"], st["cp"], tm.tables, *STRAIN,
                                tchunk=tchunk)
    t64 = tm.tables._replace(orig_cp=tm.tables.orig_cp.double())
    v64 = TC.triplet_cost_volume(st["rl"].double(), st["cp"].double(), t64,
                                 *STRAIN, tchunk=tchunk)
    L = jm.num_labels
    assert vt.shape == (jm.tables.triplets.shape[0], L, L, L) == vj.shape
    fold = 1e7 * STRAIN[0]
    np.testing.assert_array_equal(np_(vt) == fold, np_(vj) == fold)
    assert_close_f32(vt, vj, v64)


def _pair_volumes(jm, tm, sj, st, lam):
    vj = np_(JC.pairwise_cost_volume(sj["rl"], sj["cp"], jm.tables, lam, 2.0))
    vt = np_(TC.pairwise_cost_volume(st["rl"], st["cp"], tm.tables, lam, 2.0,
                                     pchunk=16))
    return vj, vt


def test_pairwise_cost_volume_matches_jax(pair_models):
    """The (Pr,L,L) rotation-difference volume: the FOLDING mask is equal,
    and the other entries agree to 1e-4 * lambda absolute. Entries where
    both rotations are the same (zero cost) are decided by
    |1 - cos| > 1e-8 on a float32 trace; on these inputs both packages
    decide every one of them alike."""
    jm, tm, sj, st = pair_models
    lam = 0.2
    vj, vt = _pair_volumes(jm, tm, sj, st, lam)
    L = jm.num_labels
    assert vt.shape == (jm.tables.pairs.shape[0], L, L) == vj.shape
    np.testing.assert_array_equal(vt >= 1e6, vj >= 1e6)
    np.testing.assert_array_equal(vt == 0.0, vj == 0.0)
    ok = vj < 1e6
    gap = float(np.abs(vt[ok] - vj[ok]).max())
    assert gap <= 1e-4 * lam, gap
    assert (vj[ok] > 0).any() and np.isfinite(vt).all()


def test_pairwise_cost_volume_fold_gate_matches_jax(pair_models):
    """On a CP grid pulled towards one vertex the folding gate fires: the
    same FOLDING entries in both packages, equal chunked and unchunked."""
    jm, tm, sj, st = pair_models
    cp = np_(sj["cp"]).copy()
    nb = np_(jm.tables.pairs)
    mates = nb[nb[:, 0] == 0][:, 1]
    cp[mates] = 0.2 * cp[mates] + 0.8 * cp[0]
    cp *= 100.0 / np.linalg.norm(cp, axis=1, keepdims=True)
    sj2 = dict(sj, cp=jnp.asarray(cp))
    st2 = dict(st, cp=torch.from_numpy(cp))
    vj, vt = _pair_volumes(jm, tm, sj2, st2, 0.2)
    assert (vj >= 1e6).sum() > 0
    np.testing.assert_array_equal(vt >= 1e6, vj >= 1e6)
    whole = np_(TC.pairwise_cost_volume(st2["rl"], st2["cp"], tm.tables, 0.2,
                                        2.0, pchunk=4096))
    np.testing.assert_array_equal(whole, vt)


@pytest.mark.parametrize("deformed,fmax", [(False, 16), (True, 16), (True, 3)])
def test_build_face_patches_matches_jax(deformed, fmax):
    """Per-CP-face source patches on a pristine CP grid (the locate path)
    and a warped one (the general search): equal padded tables, masks and
    overflow flags as arrays (the stable sort fixes which vertices a full
    face keeps); fmax 3 overflows."""
    cpm = (warped_icosphere(CP_RES, seed=5, deg=2.0) if deformed
           else Mesh.from_icosphere(CP_RES))
    src = warped_icosphere(RES, seed=2, deg=3.0).coords.astype(np.float32)
    jt = j_build_tables(cpm.coords, cpm.faces, cpm.adjacency[2])
    tt = t_build_tables(cpm.coords, cpm.faces, cpm.adjacency[2], "cpu")
    assert (tt.pristine_res >= 0) == (not deformed)
    ij, mj, oj = JC.build_face_patches(jnp.asarray(src), jt, fmax)
    it, mt, ot = TC.build_face_patches(torch.from_numpy(src), tt, fmax)
    np.testing.assert_array_equal(np_(mt), np_(mj))
    np.testing.assert_array_equal(np_(it), np_(ij))
    np.testing.assert_array_equal(np_(ot), np_(oj))
    assert np_(oj).any() == (fmax == 3)
    # every kept vertex appears once
    kept = np_(it)[np_(mt)]
    assert len(np.unique(kept)) == len(kept)


@pytest.mark.parametrize("multivariate", [False, True])
def test_triclique_likelihood_matches_jax(triclique_models, multivariate):
    """The (T,C) triangular-patch likelihood from identical state and face
    patches: atol 1e-4 (correlations of float32 resampled data)."""
    jm, tm, sj, st = triclique_models
    assert tm.fmax == jm.fmax and "face_idx" in st
    T = jm.tables.triplets.shape[0]
    L = jm.num_labels
    rng = np.random.default_rng(1)
    la, lb, lc = (rng.integers(0, L, size=(T, 8)) for _ in range(3))
    jt, tt = jm.tables, tm.tables
    if not multivariate:
        jt = jt._replace(source_data=jt.source_data[:1],
                         target_data=jt.target_data[:1])
        tt = tt._replace(source_data=tt.source_data[:1],
                         target_data=tt.target_data[:1])
    lj = JC.triclique_likelihood(
        sj["cp"], sj["rl"], jt, sj["face_idx"], sj["face_mask"], sj["src"],
        sj["abs_weights"], sj["cfweights"], jnp.asarray(la), jnp.asarray(lb),
        jnp.asarray(lc), 2, multivariate=multivariate)
    lt = TC.triclique_likelihood(
        st["cp"], st["rl"], tt, st["face_idx"], st["face_mask"], st["src"],
        st["abs_weights"], st["cfweights"], torch.from_numpy(la),
        torch.from_numpy(lb), torch.from_numpy(lc), 2,
        multivariate=multivariate)
    assert lt.shape == (T, 8)
    np.testing.assert_allclose(np_(lt), np_(lj), atol=1e-4, rtol=0)
    assert np.ptp(np_(lj)) > 1e-2


def test_triclique_combo_fn_takes_the_generic_label_path(triclique_models):
    """Under --triclique the model's triplet function has no binary_fast;
    the fusion tables then come from the (T,8) label arrays, and equal the
    JAX package's to atol 1e-4 + the strain tolerance."""
    jm, tm, sj, st = triclique_models
    tfn_j, tfn_t = jm.triplet_combo_fn(sj), tm.triplet_combo_fn(st)
    assert not hasattr(tfn_t, "binary_fast")
    K = np_(sj["cp"]).shape[0]
    rng = np.random.default_rng(2)
    lab = rng.integers(0, jm.num_labels, size=K)
    uz_j = jnp.zeros((jm.num_labels, K), jnp.float32)
    _, _, t8_j, _ = JFU.binary_move_tables(
        jnp.asarray(lab, jnp.int32), 3, uz_j, jm.tables.triplets, tfn_j)
    _, _, t8_t, p4 = TFU.binary_move_tables(
        torch.from_numpy(lab), 3, torch.zeros((jm.num_labels, K)),
        tm.tables.triplets, tfn_t)
    assert p4 is None and t8_t.shape == t8_j.shape
    np.testing.assert_allclose(np_(t8_t), np_(t8_j), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("res", [0, 1, 2, 3])
def test_face_coloring_equals_jax(res):
    """DSATUR face colours: the same integers, and a proper colouring."""
    m = Mesh.from_icosphere(res)
    faces = np.sort(m.faces.astype(np.int32), axis=1)
    cj = JCOL.face_coloring(faces, m.nvertices)
    ct = TCOL.face_coloring(faces, m.nvertices)
    np.testing.assert_array_equal(ct, cj)
    for c in range(int(ct.max()) + 1):
        verts = faces[ct == c].reshape(-1)
        assert len(np.unique(verts)) == len(verts), c


def test_pair_fusion_tables_equal_jax(pair_models):
    """Pair-mode fusion tables: colour groups, incident pair ids and own
    ends equal the JAX package's; no colour group holds both ends of a
    pair."""
    jm, tm, _, _ = pair_models
    assert tm.pairwise_mode and jm.pairwise_mode
    np.testing.assert_array_equal(tm.pairs_np, jm.pairs_np)
    jt, tt = jm.fusion_tables, tm.fusion_tables
    np.testing.assert_array_equal(np_(tt.vert_pair), np_(jt.vert_pair))
    np.testing.assert_array_equal(np_(tt.vert_pair_end),
                                  np_(jt.vert_pair_end))
    for g, gj, mj in zip(tt.groups, np_(jt.vgroups), np_(jt.vgroup_mask)):
        np.testing.assert_array_equal(np_(g), gj[mj])
        members = set(np_(g).tolist())
        assert not any(a in members and b in members for a, b in tm.pairs_np)
    carried = convert.fusion_tables(jt, device="cpu")
    np.testing.assert_array_equal(np_(carried.vert_pair), np_(tt.vert_pair))


def test_pair_fusion_matches_jax_with_injected_starts(pair_models):
    """The fusion pair path (regoption 1): same unary, pair volume, tables
    and random starts give the same labeling, energy to rtol 1e-5."""
    jm, tm, sj, st = pair_models
    L = jm.num_labels
    uj = jm.unary(sj).T[:L]
    K = uj.shape[1]
    pfn_j = jm.pair_combo_fn(sj)
    zero_j = lambda la, lb, lc: jnp.zeros(la.shape, jnp.float32)  # noqa: E731
    none_j = jnp.zeros((0, 3), jnp.int32)
    lab_j = JFU.fusion_optimize(
        jnp.zeros(K, jnp.int32), uj, none_j, jm.fusion_tables, zero_j,
        jnp.int32(L), pairs=jm.tables.pairs, pair_combo_fn=pfn_j)
    e_j = float(JFU.fusion_energy(lab_j, uj, none_j, zero_j,
                                  pairs=jm.tables.pairs, pair_combo_fn=pfn_j))

    ut = torch.from_numpy(np.array(uj))
    vol = torch.from_numpy(np.array(JC.pairwise_cost_volume(
        sj["rl"], sj["cp"], jm.tables, jm.cfg.reglambda, jm.cfg.rexp)))
    pr = torch.arange(vol.shape[0])[:, None]
    pfn_t = lambda pa, pb: vol[pr, pa, pb]                        # noqa: E731
    zero_t = lambda la, lb, lc: torch.zeros(la.shape)             # noqa: E731
    none_t = torch.zeros((0, 3), dtype=torch.int64)
    lab_t = TFU.fusion_optimize(
        torch.zeros(K, dtype=torch.int64), ut, none_t,
        convert.fusion_tables(jm.fusion_tables, device="cpu"), zero_t, L,
        random_starts=jax_fusion_starts(K), pairs=tm.tables.pairs,
        pair_combo_fn=pfn_t)
    e_t = float(TFU.fusion_energy(lab_t, ut, none_t, zero_t,
                                  pairs=tm.tables.pairs, pair_combo_fn=pfn_t))
    np.testing.assert_array_equal(np_(lab_t), np_(lab_j))
    np.testing.assert_allclose(e_t, e_j, rtol=1e-5)
    assert (np_(lab_t) != 0).any()

    # the port's own volume, tables and a seeded generator: a descent too
    own = tm.pair_combo_fn(st)
    lab_g = TFU.fusion_optimize(
        torch.zeros(K, dtype=torch.int64), ut, none_t, tm.fusion_tables,
        zero_t, L, generator=torch.Generator().manual_seed(7),
        pairs=tm.tables.pairs, pair_combo_fn=own)
    e_0 = float(TFU.fusion_energy(torch.zeros(K, dtype=torch.int64), ut,
                                  none_t, zero_t, pairs=tm.tables.pairs,
                                  pair_combo_fn=own))
    assert float(TFU.fusion_energy(lab_g, ut, none_t, zero_t,
                                   pairs=tm.tables.pairs,
                                   pair_combo_fn=own)) <= e_0


def test_pair_fusion_binary_solve_is_exact_on_12_nodes():
    """Every binary move of a 12-CP pair problem (unary data volume + the
    rotation-difference pairs) solved by the port equals the 4096-state
    enumeration minimum (float32 sums: rtol 1e-6)."""
    target = convert.mesh(Mesh.from_icosphere(3))
    control = convert.mesh(Mesh.from_icosphere(0))
    fs = smooth_pattern(target.coords, 3)[None]
    fr = smooth_pattern(target.coords, 4)[None]
    tm = TM.PairwiseModel(TM.ModelConfig(simval=2, reglambda=0.3, sg_res=2,
                                         regmode=1), control, target, target,
                          fs, fr, device="cpu")
    s = tm.setup_iteration(np.ones((1, target.nvertices)))
    unary = tm.unary(s).T
    K, L = control.nvertices, tm.num_labels
    assert K == 12 and L > 2 and tm.tables.pairs.shape[0] == 30
    pfn = tm.pair_combo_fn(s)
    pairs = tm.tables.pairs
    none = torch.zeros((0, 3), dtype=torch.int64)
    zero = lambda la, lb, lc: torch.zeros(la.shape)               # noqa: E731
    gen = torch.Generator().manual_seed(0)
    X = torch.from_numpy(((np.arange(1 << K)[:, None]
                           >> np.arange(K)[None, :]) & 1).astype(np.int64))
    labeling = torch.zeros(K, dtype=torch.int64)
    for alpha in list(range(1, L)) + list(range(L)):
        u0, u1, t8, p4 = TFU.binary_move_tables(labeling, alpha, unary, none,
                                                zero, pairs, pfn)
        assert t8 is None and p4.shape == (30, 4)
        x = TFU.fusion_binary_solve(
            labeling, alpha, unary, none, tm.fusion_tables, zero,
            starts=torch.randint(0, 2, (2, K), generator=gen), pairs=pairs,
            pair_combo_fn=pfn)
        e = float(ticm.binary_energy(x, u0, u1, t8, none, p4, pairs))
        e_min = float(ticm.binary_energy(X, u0, u1, t8, none, p4,
                                         pairs).min())
        assert e == pytest.approx(e_min, rel=1e-6, abs=1e-6), alpha
        labeling = torch.where(x == 1, torch.full_like(labeling, alpha),
                               labeling)


def test_msmpair_driver_matches_jax(tmp_path):
    """Whole driver, regoption 1 (AFFINE + two pair levels at ico-3), both
    packages on the same subject: fold-free, sulc CC above the before-CC,
    chosen_gated == 0, and the CCs within 0.01 of each other (measured
    0.8474 in both)."""
    run_variant_pair(tmp_path, "pair", cc_tol=0.01)
