"""The subject-sharded groupwise optimiser and the row-sharded pairwise cost
volumes of newmsm_tpu_torch on the CPU, over real gloo ranks.

One spawn of 4 ranks (multihost.run_local_ranks: a FileStore rendezvous, no
port, one thread a rank) serves W = 1, 2 and 4: every rank holds its own
1-rank comm, its pair's (ranks 0,1 or 2,3) and the world's. The port at
W = 2 and 4, under both maps exchanges, must give bitwise the partner map,
labeling, energy and patch_need of its one-rank GroupFusion, and match the
JAX package's make_fusion_fn on a 4-device virtual mesh from the same
random starts (partner and labeling equal, energy rtol 1e-4). A second
spawn runs the whole group driver at W = 4, 2 and 1 the same way.

Rank workers are module-level functions and this module imports neither
JAX nor the JAX package at its top: spawned ranks import it by name. The
problems of tests/test_group_sharded.py (S = 8, control ico-1, template
ico-2) are built in the parent with the JAX package and carried over.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from newmsm_tpu_torch.parallel import group_fusion as TGF
from newmsm_tpu_torch.parallel import multihost as mh
from newmsm_tpu_torch.parallel import pairwise_sharding as TPS

S = 8
WORLD = 4
SIDES = (1, 2, 4)                # the rank counts W that one spawn tests
EXCHANGES = ("gather", "ring")


class _Starts:
    """Injected fusion starts, alpha -> (n_restarts, S*K); picklable."""

    def __init__(self, starts):
        self.starts = starts

    def __call__(self, alpha):
        return torch.from_numpy(self.starts[alpha])


def _groups():
    """This rank's process group for W = 1 (none), 2 (ranks 0,1 or 2,3)
    and 4 (the world). Every rank makes every group, in the same order."""
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    return {1: None, 2: pairs[dist.get_rank() // 2], 4: dist.group.WORLD}


def _comms():
    """This rank's SubjectComm for W = 1, 2, 4."""
    return {W: mh.SubjectComm(g) for W, g in _groups().items()}


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------- the fusion spawn

def _fusion_rank(case):
    """Per W: partner, both exchanges' fusion calls, the pmax = 2 call, the
    strongly deformed partner, the apply stage of the rank's own subjects
    and the sharded pairwise volumes, as numpy."""
    tst, trip, K = case["tst"], case["trip"], case["K"]
    maps, cp, spac = _t(case["maps"]), _t(case["cp"]), _t(case["spac"])
    starts = _Starts(case["starts"])
    lab0 = torch.zeros(S * K, dtype=torch.int64)
    out = {}
    for W, comm in _comms().items():
        own = mh.process_subject_slice(S, comm)
        partner = TGF.make_partner_fn(tst, S, comm)(cp[own])
        tables = TGF.build_iteration_tables(partner.numpy(), trip, S, K, "cpu")
        for ex in EXCHANGES:
            fusion = TGF.make_fusion_fn(tst, S, random_starts=starts,
                                        comm=comm, maps_exchange=ex)
            lab, energy, need = fusion(maps[own], cp[own], spac[own], lab0,
                                       partner, tables)
            out[W, ex] = (partner.numpy(), lab.numpy(), float(energy),
                          int(need))
        tight = TGF.make_fusion_fn(tst._replace(pmax=2, sweeps=1), S,
                                   random_starts=starts, comm=comm)
        lab, energy, need = tight(maps[own], cp[own], spac[own], lab0,
                                  partner, tables)
        out[W, "tight"] = (lab.numpy(), float(energy), int(need))
        out[W, "strong"] = TGF.make_partner_fn(tst, S, comm)(
            _t(case["strong_cp"])[own]).numpy()

        # the apply stage of the W = 1 labeling, own subjects
        labeling = _t(out[1, "gather"][1])
        apply = TGF.make_apply_fn(tst, S, case["control"], case["dg"], comm)
        res = apply(_t(case["dg_coords"])[own], cp[own], labeling)
        out[W, "apply"] = tuple(r.numpy() for r in res)

        v = case["volumes"]
        out[W, "unary"] = {
            mode: TPS.make_sharded_unary(
                comm, v["tables"], _t(v["src_data"][:v["dims"][mode]]),
                _t(v["tgt_data"][:v["dims"][mode]]), _t(v["cfw"]), 2, mode,
                v["pmax"], 1.0)(*(_t(a) for a in v["unary_args"])).numpy()
            for mode in ("univariate", "multivariate")}
        out[W, "triplet"] = TPS.make_sharded_triplet_volume(
            comm, *v["strain"])(*(_t(a) for a in v["triplet_args"])).numpy()
    return out


def _jax_problem():
    """The problems in both packages: test_group_sharded.build_problem(8)
    with the JAX package's random starts, strongly deformed CP grids
    (noise 25), warped ico-2 data grids for the apply stage, and the
    inputs of the sharded pairwise volumes."""
    import jax
    import jax.numpy as jnp
    from newmsm_tpu.core.mesh import Mesh
    from newmsm_tpu_torch import convert
    from test_group_sharded import build_problem
    from torch_helpers import warped_icosphere

    st, trip, maps, cp, spac, K, L = build_problem(S)
    starts = np.stack([np.array(jax.random.bernoulli(
        jax.random.fold_in(jax.random.PRNGKey(7), alpha), 0.5,
        (st.n_restarts, S * K)).astype(jnp.int32)).astype(np.int64)
        for alpha in range(L)])
    control = Mesh.from_icosphere(1)
    control.true_rescale(100.0)
    rng = np.random.default_rng(11)
    strong = np.broadcast_to(np.asarray(control.coords, np.float32),
                             (S, K, 3)).copy()
    strong += rng.normal(size=strong.shape).astype(np.float32) * 25.0
    strong /= np.linalg.norm(strong, axis=-1, keepdims=True) / 100.0
    dg = Mesh.from_icosphere(2)
    dg_coords = np.stack([warped_icosphere(2, seed=20 + s, deg=3.0).coords
                          for s in range(S)]).astype(np.float32)

    # pairwise volumes: one iteration's state of the JAX package's pairwise
    # model (ico-1 control points, warped ico-3 source, pristine ico-3
    # target), as the unary and strain tests of the port use it
    from test_torch_costs_variants import STRAIN, _models
    jm, _, sj, _ = _models()
    t = jm.tables
    tri = np.asarray(t.triplets)
    cp_m = np.asarray(sj["cp"])
    volumes = dict(
        jtables=t.target_tables, src_data=np.asarray(t.source_data),
        tgt_data=np.asarray(t.target_data), cfw=np.asarray(sj["cfweights"]),
        pmax=jm.pmax, dims={"univariate": 1, "multivariate": 2},
        unary_args=(cp_m, np.asarray(sj["labels"]), np.asarray(jm.centre),
                    np.asarray(t.maxsep), np.asarray(sj["abs_weights"]),
                    np.asarray(sj["src"])),
        triplet_args=(np.asarray(sj["rl"]), tri.astype(np.int64), cp_m[tri],
                      np.asarray(t.orig_cp)[tri]),
        strain=STRAIN)
    volumes["tables"] = convert.search_tables(volumes["jtables"], "cpu")
    port_volumes = {k: v for k, v in volumes.items() if k != "jtables"}
    case = dict(tst=convert.group_statics(st, "cpu"), trip=trip, maps=maps,
                cp=cp, spac=spac, K=K, starts=starts, strong_cp=strong,
                control=convert.mesh(control), dg=convert.mesh(dg),
                dg_coords=dg_coords, volumes=port_volumes)
    return st, case, volumes


def _jax_side(st, case, volumes):
    """The JAX package's sharded functions on a 4-device virtual mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P
    from newmsm_tpu.parallel import group_fusion as JGF
    from newmsm_tpu.parallel import pairwise_sharding as JPS

    K = case["K"]
    mesh = JMesh(np.array(jax.devices()[:WORLD]), ("subjects",))
    sh = NamedSharding(mesh, P("subjects"))

    def put(a):
        return jax.device_put(jnp.asarray(a), sh)

    out = {}
    cp, spac, maps = put(case["cp"]), put(case["spac"]), put(case["maps"])
    partner = np.asarray(JGF.make_partner_fn(mesh, st, S)(cp))
    tables = JGF.build_iteration_tables(partner, case["trip"], S, K)
    lab0 = jnp.zeros((S * K,), jnp.int32)
    lab, energy, need = JGF.make_fusion_fn(mesh, st, S)(
        maps, cp, spac, lab0, jnp.asarray(partner), tables)
    out["fusion"] = (partner, np.asarray(lab), float(energy), int(need))
    lab, energy, need = JGF.make_fusion_fn(
        mesh, st._replace(pmax=2, sweeps=1), S)(
        maps, cp, spac, lab0, jnp.asarray(partner), tables)
    out["tight"] = (np.asarray(lab), float(energy), int(need))
    out["strong"] = np.asarray(JGF.make_partner_fn(mesh, st, S)(
        put(case["strong_cp"])))

    vmesh = JMesh(np.array(jax.devices()[:WORLD]), ("cps",))
    v = volumes
    out["unary"] = {
        mode: np.asarray(JPS.make_sharded_unary(
            vmesh, v["jtables"], jnp.asarray(v["src_data"][:v["dims"][mode]]),
            jnp.asarray(v["tgt_data"][:v["dims"][mode]]), jnp.asarray(v["cfw"]),
            2, mode, v["pmax"], 1.0)(*(jnp.asarray(a)
                                       for a in v["unary_args"])))
        for mode in ("univariate", "multivariate")}
    out["triplet"] = np.asarray(JPS.make_sharded_triplet_volume(
        vmesh, *v["strain"])(*(jnp.asarray(a) for a in v["triplet_args"])))
    return out


@pytest.fixture(scope="module")
def sharded():
    st, case, volumes = _jax_problem()
    ranks = mh.run_local_ranks(_fusion_rank, WORLD, args=(case,),
                               timeout=400, threads=1)
    return dict(case=case, ranks=ranks, jax=_jax_side(st, case, volumes))


@pytest.mark.parametrize("W", SIDES)
@pytest.mark.parametrize("exchange", EXCHANGES)
def test_fusion_is_bitwise_that_of_one_rank(sharded, W, exchange):
    """On every rank: partner map, labeling, energy and patch_need of W
    ranks under `exchange` equal the one-rank gather call's."""
    ref = sharded["ranks"][0][1, "gather"]
    assert (ref[1] != 0).any(), "the fixture never moved a node"
    for r, out in enumerate(sharded["ranks"]):
        got = out[W, exchange]
        np.testing.assert_array_equal(got[0], ref[0], err_msg=f"rank {r}")
        np.testing.assert_array_equal(got[1], ref[1], err_msg=f"rank {r}")
        assert got[2:] == ref[2:], (r, got[2:], ref[2:])


def test_fusion_matches_the_jax_package_on_four_devices(sharded):
    """The port at W = 4 against the JAX package's make_fusion_fn on a
    4-device mesh, the same random starts: partner map and labeling equal,
    energy rtol 1e-4, equal patch_need."""
    partner, lab, energy, need = sharded["jax"]["fusion"]
    got = sharded["ranks"][0][4, "gather"]
    np.testing.assert_array_equal(got[0], partner)
    np.testing.assert_array_equal(got[1], lab)
    np.testing.assert_allclose(got[2], energy, rtol=1e-4)
    assert got[3] == need


def test_patch_need_overflow_is_the_same_for_every_rank_count(sharded):
    """pmax = 2: patch_need is MAX-combined over the ranks, above 2, and
    the same at W = 1, 2, 4 and in the JAX package; labeling and energy of
    the truncated call bitwise the one-rank call's."""
    ref = sharded["ranks"][0][1, "tight"]
    assert ref[2] > 2
    assert ref[2] == sharded["jax"]["tight"][2]
    for out in sharded["ranks"]:
        for W in SIDES:
            lab, energy, need = out[W, "tight"]
            np.testing.assert_array_equal(lab, ref[0])
            assert (energy, need) == (ref[1], ref[2])


def test_partner_on_strongly_deformed_grids_matches_the_jax_package(sharded):
    """CP noise 25 (Voronoi assignment changed): W = 1, 2, 4 equal, and
    equal to the JAX package's on 4 devices."""
    want = sharded["jax"]["strong"]
    assert (want != np.arange(want.shape[-1])).any()
    for out in sharded["ranks"]:
        for W in SIDES:
            np.testing.assert_array_equal(out[W, "strong"], want)


@pytest.mark.parametrize("W", SIDES)
def test_apply_of_own_subjects_is_bitwise_the_one_rank_apply(sharded, W):
    """make_apply_fn at W ranks: each rank applies its own subjects alone,
    bitwise the one-rank apply's rows."""
    ref = sharded["ranks"][0][1, "apply"]
    assert np.abs(ref[1] - sharded["case"]["cp"]).max() > 1.0   # CPs moved
    for r, out in enumerate(sharded["ranks"]):
        own = slice(r % W * (S // W), (r % W + 1) * (S // W))
        for got, want in zip(out[W, "apply"], ref):
            np.testing.assert_array_equal(got, want[own],
                                          err_msg=f"W {W} rank {r}")


@pytest.mark.parametrize("mode", ["univariate", "multivariate"])
def test_sharded_unary_volume(sharded, mode):
    """CP rows over 4 ranks (K = 42 padded to 44): bitwise the port's
    one-rank volume at every W, and the JAX package's make_sharded_unary on
    4 devices within atol 1e-4 (the unary tests' tolerance)."""
    ref = sharded["ranks"][0][1, "unary"][mode]
    labels = sharded["case"]["volumes"]["unary_args"][1]
    assert ref.shape == (42, labels.shape[0])
    for out in sharded["ranks"]:
        for W in SIDES:
            np.testing.assert_array_equal(out[W, "unary"][mode], ref)
    np.testing.assert_allclose(ref, sharded["jax"]["unary"][mode], atol=1e-4,
                               rtol=0)


def test_sharded_triplet_volume(sharded):
    """Face rows over 4 ranks (T = 80): bitwise the port's one-rank volume
    at every W; against the JAX package's make_sharded_triplet_volume
    rtol 2e-4 (assert_close_f32, float64 evaluation included), FOLDING
    entries equal. The state of the port's strain-volume test."""
    from torch_helpers import assert_close_f32
    from newmsm_tpu_torch.reg import costs as TC
    v = sharded["case"]["volumes"]
    ref = sharded["ranks"][0][1, "triplet"]
    L = v["triplet_args"][0].shape[1]
    assert ref.shape == (80, L, L, L)
    for out in sharded["ranks"]:
        for W in SIDES:
            np.testing.assert_array_equal(out[W, "triplet"], ref)
    want = sharded["jax"]["triplet"]
    fold = 1e7 * v["strain"][0]
    np.testing.assert_array_equal(ref == fold, want == fold)
    rl, tri, cur, orig = (_t(a) for a in v["triplet_args"])
    ref64 = TC.triplet_volume_arrays(rl.double(), tri, cur.double(),
                                     orig.double(), *v["strain"])
    assert_close_f32(ref, want, ref64.reshape(ref.shape).float())


# ------------------------------------------------------------ host-side plan

@pytest.mark.parametrize("n_items,n_dev", [(8, 1), (8, 3), (28, 4), (0, 2)])
def test_round_robin_slots_equal(n_items, n_dev):
    from newmsm_tpu.parallel import group_fusion as JGF
    np.testing.assert_array_equal(TGF._round_robin_slots(n_items, n_dev),
                                  JGF._round_robin_slots(n_items, n_dev))


@pytest.mark.parametrize("nl", [1, 2, 4])
def test_ring_local_pairs_and_block_ids_equal(nl):
    from newmsm_tpu.parallel import group_fusion as JGF
    np.testing.assert_array_equal(TGF._ring_local_pairs(nl),
                                  JGF._ring_local_pairs(nl))
    blocks = TGF.pair_blocks(S)
    for i, (a, b) in enumerate(blocks):
        assert TGF._block_id(int(a), int(b), S) == i == JGF._block_id(a, b, S)


class _Rank:
    def __init__(self, world, rank):
        self.world, self.rank = world, rank


@pytest.mark.parametrize("W", [1, 2, 4, 8])
@pytest.mark.parametrize("exchange", EXCHANGES)
def test_rank_plans_cover_every_pair_block_once(W, exchange):
    """Over the ranks, every (a,b) block is planned exactly once; a ring
    row reads a's and b's maps from the rank's window (own block, then
    the visiting rank's); each rank builds patches only for the first
    subjects of its own blocks."""
    st = TGF.GroupLevelStatics(
        labels=torch.zeros(3, 3), centre=torch.zeros(3),
        orig_cp=torch.zeros(5, 3), cp_faces=torch.zeros(2, 3,
                                                        dtype=torch.int64),
        tmpl_coords=torch.zeros(7, 3), mask_w=None, cp_search=None, mu=0.4,
        kappa=1.6, k_exp=2.0, rexp=2.0, reglambda=0.1, subcorr=0.8,
        simval=2, percentile=0.75, pmax=4, cprange=1.0, fixnan=False)
    blocks = TGF.pair_blocks(S)
    seen = []
    nl = S // W
    for rank in range(W):
        f = TGF.GroupFusion(st, S, comm=_Rank(W, rank),
                            maps_exchange=exchange)
        firsts = set()
        for r, step in enumerate(f.plan):
            v = (rank - r) % W
            window = list(range(rank * nl, (rank + 1) * nl)) + (
                list(range(v * nl, (v + 1) * nl)) if r else [])
            for bid, a, b, ma, mb in step.tolist():
                assert (a, b) == tuple(blocks[bid])
                if exchange == "ring":
                    assert (window[ma], window[mb]) == (a, b)
                else:
                    assert (ma, mb) == (a, b)       # rows of the gathered maps
                seen.append(bid)
                firsts.add(a)
        assert f.patch_subjects == sorted(firsts)
    assert sorted(seen) == list(range(len(blocks)))


# ------------------------------------------------------- the driver spawn

def _driver_rank(case):
    """The group driver over the world (W = 4), a pair of ranks (W = 2) and
    no group (W = 1: every rank alone, with the default group up, as a
    pipeline that builds the driver with a device only runs under
    torchrun)."""
    from newmsm_tpu_torch.core.mesh import Mesh
    from newmsm_tpu_torch.reg.group import GroupMeshRegistration
    rank = dist.get_rank()
    out = {}
    for W, group in sorted(_groups().items(), reverse=True):
        g = GroupMeshRegistration(device="cpu", group=group)
        g.set_inputs([Mesh(coords=c, faces=case["faces"])
                      for c in case["coords"]])
        g.set_data_list([d.copy() for d in case["datasets"]])
        g.set_template(Mesh(coords=case["tmpl"], faces=case["tmpl_faces"]))
        g.outdir = os.path.join(case["dir"], f"W{W}_r{rank}_")
        g.metrics_path = g.outdir + "metrics.jsonl"
        g.run_multiresolutions(case["cfg"])
        ids = g._owned_ids()
        out[W] = dict(
            world=g.comm.world, owned=ids,
            energies=[e for _, _, e in g.energy_log],
            loaded=[s for s, m in enumerate(g.meshes) if m is not None],
            spheres={s: g.sph_reg[s].coords for s in ids},
            held=[s for s, m in enumerate(g.sph_reg) if m is not None])
    return out


@pytest.fixture(scope="module")
def driver_runs(tmp_path_factory):
    """make_group(8, res=2), group_config(iters=2) with data and sampling
    grids 2 and intensity_norm, through the port's driver on 4 ranks."""
    from newmsm_tpu_torch import convert
    from newmsm_tpu_torch.reg.config import RegConfig
    from test_group import group_config, make_group
    from newmsm_tpu.core.mesh import Mesh
    meshes, datasets = make_group(S, res=2, degrees=6.0)
    cfg = group_config(iters=2)
    cfg.datagrid = [2]
    cfg.sampgrid = [2]
    cfg.intensity_norm = True
    tcfg = RegConfig()
    tcfg.__dict__.update(cfg.__dict__)
    tmpl = convert.mesh(Mesh.from_icosphere(2))
    d = tmp_path_factory.mktemp("driver")
    case = dict(coords=[convert.mesh(m).coords for m in meshes],
                faces=convert.mesh(meshes[0]).faces,
                datasets=[np.asarray(x) for x in datasets], tmpl=tmpl.coords,
                tmpl_faces=tmpl.faces, cfg=tcfg, dir=str(d))
    runs = mh.run_local_ranks(_driver_rank, WORLD, args=(case,), timeout=400,
                              threads=1)
    return runs, d


@pytest.mark.parametrize("W", [4, 2])
def test_group_driver_is_bitwise_that_of_one_rank(driver_runs, W):
    """The whole driver at W ranks against one rank: equal energy logs,
    bitwise equal spheres (ranks 0,1 and 2,3 are two W = 2 runs)."""
    runs, _ = driver_runs
    one = runs[0][1]
    assert len(one["energies"]) == 2
    for first in range(0, WORLD, W):
        spheres = {}
        for r in range(first, first + W):
            got = runs[r][W]
            assert got["world"] == W
            assert got["energies"] == one["energies"], (r, got["energies"])
            spheres.update(got["spheres"])
        assert sorted(spheres) == list(range(S))
        for s in range(S):
            np.testing.assert_array_equal(spheres[s], one["spheres"][s])


def test_group_driver_given_no_group_is_one_rank_under_a_process_group(
        driver_runs):
    """With the default process group up, a driver given no group (as
    pipelines.gmsm builds it) is one rank: on every rank it loads, holds
    and writes all S subjects, with the same energies and spheres."""
    runs, d = driver_runs
    one = runs[0][1]
    for r, run in enumerate(runs):
        got = run[1]
        assert got["world"] == 1 and got["owned"] == list(range(S))
        assert got["held"] == got["loaded"] == list(range(S))
        assert got["energies"] == one["energies"]
        for s in range(S):
            np.testing.assert_array_equal(got["spheres"][s], one["spheres"][s])
        assert all(os.path.exists(d / f"W1_r{r}_sphere-{s}.reg.surf.gii")
                   for s in range(S))


def test_group_driver_ranks_hold_and_write_only_their_subjects(driver_runs):
    """At W = 4 each rank loads its two subjects and, under intensity_norm,
    subject 0 (the histogram reference); it keeps state and writes outputs
    for its own subjects only; rank 0 alone writes the metrics, whose iter
    events read devices 4."""
    import json
    runs, d = driver_runs
    files = os.listdir(d)
    for r, run in enumerate(runs):
        got = run[4]
        own = [2 * r, 2 * r + 1]
        assert got["owned"] == own and got["held"] == own
        assert got["loaded"] == sorted({0, *own})
        written = sorted(f for f in files if f.startswith(f"W4_r{r}_"))
        want = sorted([f"W4_r{r}_sphere-{s}.reg.surf.gii" for s in own]
                      + [f"W4_r{r}_transformed_and_reprojected-{s}"
                         ".func.gii" for s in own]
                      + ([f"W4_r{r}_metrics.jsonl"] if r == 0 else []))
        assert written == want, (r, written)
    events = [json.loads(line) for line in open(d / "W4_r0_metrics.jsonl")]
    iters = [e for e in events if e["event"] == "iter"]
    assert len(iters) == 2 and all(e["devices"] == 4 for e in iters)
    assert all(e["maps_exchange"] == "gather" for e in iters)
    assert all(len(e["opt_s_by_rank"]) == 4 for e in iters)
    ranks = [e for e in events if e["event"] == "ranks"]
    assert len(ranks) == 1 and len(ranks[0]["locate_launches"]) == 4
