"""The cohort pipelines of newmsm_tpu_torch (pipelines.gmsm.run_gmsm,
run_cgmsm, pipelines.cohort.run_cohort) over ranks on the CPU, with the
host-array collectives of parallel/multihost.py they use.

One spawn of 4 ranks (multihost.run_local_ranks: a FileStore rendezvous,
one thread a rank) runs every pipeline over the world (W = 4) and with no
group (W = 1: each rank alone while the process group is up); a spawn of
2 ranks runs run_gmsm and run_cgmsm over its world (W = 2). Every rank's
result must be bitwise that of one rank; only rank 0 writes the group
files; cgMSM's 2-subject nodes run on a 2-rank sub-group at W = 4 and on
the whole group at W = 2. The port's run_gmsm at W = 4 is held to the JAX
package's run_gmsm on 4 virtual CPU devices at the group driver's agreed
tolerances (ROADMAP queue 3: first energy rtol 1e-3, CC 0.02, on a
template rotated off the data grid).

Rank workers are module-level functions and this module imports neither
JAX nor the JAX package at its top: spawned ranks import it by name.
"""
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch.distributed as dist

from newmsm_tpu_torch.parallel import multihost as mh

S = 4
GROUPS = {"A": ["s0", "s1"], "B": ["s2"], "C": ["s3"]}
TREE = [("A", "B", "AB"), ("AB", "C", "ABC")]


def _record_saves() -> list:
    """Names of the files this process writes through Mesh.save from now
    on."""
    from newmsm_tpu_torch.core.mesh import Mesh
    written, save = [], Mesh.save

    def recording(self, path, *args, **kw):
        written.append(os.path.basename(path))
        return save(self, path, *args, **kw)
    Mesh.save = recording
    return written


def _inputs(case):
    from newmsm_tpu_torch.core.mesh import Mesh
    meshes = [Mesh(coords=c, faces=case["faces"], data=np.zeros((1, len(c))))
              for c in case["coords"]]
    tmpl = Mesh(coords=case["tmpl"], faces=case["tmpl_faces"])
    return meshes, [d.copy() for d in case["datasets"]], tmpl


def _gmsm_out(res, written):
    return dict(energies=res.energies, stats=res.stats, mean=res.mean_map,
                stdev=res.stdev_map, resampled=res.resampled_data,
                spheres=[(m.coords, m.faces, m.data)
                         for m in res.dedrifted_spheres],
                written=sorted(written))


def _state_out(state):
    return {gid: dict(members=v["members"], mean=v["mean"],
                      meshes={s: (m.coords, m.faces, m.data)
                              for s, m in v["meshes"].items()})
            for gid, v in state.items()}


def _run_gmsm_from_starts(case, meshes, datasets, tmpl):
    """run_gmsm over the world with the JAX package's fusion starts."""
    from newmsm_tpu_torch.pipelines import gmsm
    from test_torch_sharded import _Starts
    plain = gmsm.GroupMeshRegistration

    class Driver(plain):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.fusion_random_starts = _Starts(case["starts"])
    gmsm.GroupMeshRegistration = Driver
    try:
        return gmsm.run_gmsm(meshes, datasets, tmpl, case["cfg"],
                             device="cpu", group=dist.group.WORLD)
    finally:
        gmsm.GroupMeshRegistration = plain


def _pipelines_rank(case, world_only=False):
    """run_gmsm and run_cgmsm over the world and (unless `world_only`) with
    no group, run_cohort over the world, run_gmsm from the JAX package's
    starts; and the host collectives."""
    from newmsm_tpu_torch.pipelines import cohort, gmsm
    rank, world = dist.get_rank(), dist.get_world_size()
    cwd = os.path.join(case["dir"], f"cwd{world}_{rank}")
    os.makedirs(cwd)
    os.chdir(cwd)             # node registrations write under "./"
    written = _record_saves()
    meshes, datasets, tmpl = _inputs(case)
    subjects = {f"s{i}": (meshes[i], datasets[i]) for i in range(S)}
    sides = {world: dist.group.WORLD} if world_only else \
        {world: dist.group.WORLD, 1: None}
    out = {"collectives": _collectives(rank, world)}
    for W, group in sides.items():
        del written[:]
        prefix = os.path.join(case["dir"], f"gmsm_W{W}_of{world}_" + (
            f"r{rank}_" if W == 1 else ""))
        res = gmsm.run_gmsm(meshes, datasets, tmpl, case["cfg"],
                            outdir=prefix, device="cpu", group=group)
        out["gmsm", W] = _gmsm_out(res, written)
        out["cgmsm", W] = _state_out(gmsm.run_cgmsm(
            GROUPS, TREE, subjects, tmpl, case["cfg"], device="cpu",
            group=group))
    if not world_only:
        res = cohort.run_cohort(GROUPS, TREE, "ABC", subjects, tmpl,
                                case["cfg"], min_size=1, device="cpu",
                                group=dist.group.WORLD)
        out["cohort"] = dict(tree=res.study.tree, state=_state_out(res.state))
        out["from_starts"] = _gmsm_out(
            _run_gmsm_from_starts(case, meshes, datasets, tmpl), [])
    return out


def _collectives(rank, world):
    """all_gather_arrays / broadcast_arrays with rank-dependent counts,
    shapes and dtypes; share(); for_subjects() at S = 1..world, twice; its
    refusal on a group that does not span the world."""
    comm = mh.SubjectComm(dist.group.WORLD)
    mine = [np.arange(rank + 1, dtype=np.float64) / 3.0,
            np.full((2, rank), rank, np.int32)][:1 + rank % 2]
    if rank == 0:
        mine.append(np.array([[np.pi, -0.0]], np.float32))
    got = dict(gathered=comm.all_gather_arrays(mine),
               share=list(mh.share(3, comm)),
               bcast=comm.broadcast_arrays(
                   mine if rank == 1 else [np.zeros(5)], src=1))
    for n in range(1, world + 1):
        sub = comm.for_subjects(n)
        got["for", n] = None if sub is None else (sub.world, sub.rank)
        again = comm.for_subjects(n)
        got["kept", n] = (sub is None and again is None) or (
            sub.group is again.group)
    if world == 4:
        # every rank makes the 3-rank group; its members ask for 2 subjects
        three = dist.new_group([0, 1, 2])
        if rank < 3:
            try:
                mh.SubjectComm(three).for_subjects(2)
                got["refused"] = False
            except ValueError:
                got["refused"] = True
    return got


def _jax_run_gmsm(meshes, datasets, tmpl, cfg):
    """The JAX package's run_gmsm (4 of the 8 virtual devices for S = 4),
    with its driver's energy log."""
    from newmsm_tpu.pipelines import gmsm as jgmsm
    from newmsm_tpu.reg.group import GroupMeshRegistration as JG
    logs, run = [], JG.run_multiresolutions

    def logged(self, config=None):
        out = run(self, config)
        logs.append((self.device_mesh.devices.size, list(self.energy_log)))
        return out
    JG.run_multiresolutions = logged
    try:
        res = jgmsm.run_gmsm(meshes, datasets, tmpl, cfg)
    finally:
        JG.run_multiresolutions = run
    return res, logs[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """make_group(4, degrees 6), group_config(iters=2) at cprange 1.1 on a
    rotated ico-3 template: the 4-rank and 2-rank spawns, beside the JAX
    package's run_gmsm."""
    from newmsm_tpu_torch import convert
    from test_group import group_config, make_group
    from test_torch_group import (jax_group_starts, rotated_template,
                                  torch_config)
    meshes, datasets = make_group(S, degrees=6.0)
    cfg = group_config(iters=2)
    cfg.cprange = 1.1
    tmpl = convert.mesh(rotated_template())
    d = tmp_path_factory.mktemp("ranks")
    case = dict(coords=[convert.mesh(m).coords for m in meshes],
                faces=convert.mesh(meshes[0]).faces,
                datasets=[np.asarray(x) for x in datasets], tmpl=tmpl.coords,
                tmpl_faces=tmpl.faces, cfg=torch_config(cfg), dir=str(d))
    # the JAX package's starts of its 19 labels, S x 42 control points
    starts = jax_group_starts(S * 42)
    case["starts"] = np.stack([starts(a).numpy() for a in range(19)])

    with ThreadPoolExecutor(2) as pool:
        four = pool.submit(mh.run_local_ranks, _pipelines_rank, 4,
                           args=(case,), timeout=400, threads=1)
        two = pool.submit(mh.run_local_ranks, _pipelines_rank, 2,
                          args=(case, True), timeout=400, threads=1)
        jax = _jax_run_gmsm(meshes, datasets, rotated_template(), cfg)
        return dict(four=four.result(), two=two.result(), jax=jax, dir=d)


def _by_w(runs, W):
    return runs["four"] if W in (1, 4) else runs["two"]


def _assert_same(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_same(got[k], want[k], f"{what}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, (what, got, want)


@pytest.mark.parametrize("W", [2, 4])
def test_run_gmsm_is_bitwise_that_of_one_rank(runs, W):
    """Energies, stats, mean and stdev maps, resampled maps and dedrifted
    spheres of W ranks equal the one-rank run's on every rank."""
    one = runs["four"][0]["gmsm", 1]
    assert len(one["energies"]) == 2 and len(one["spheres"]) == S
    for r, out in enumerate(_by_w(runs, W)):
        got = dict(out["gmsm", W], written=one["written"])
        _assert_same(got, one, f"W {W} rank {r}")


@pytest.mark.parametrize("W", [2, 4])
def test_run_gmsm_group_files_are_written_by_rank_0_alone(runs, W):
    """Rank 0 writes the dedrifted spheres and the mean and stdev maps;
    every rank writes its own subjects' registration outputs and nothing
    else; the files exist once."""
    per = S // W
    group_files = [f"sphere-{s}.dedrift.reg.surf.gii" for s in range(S)] + [
        "mean.func.gii", "stdev.func.gii"]
    for r, out in enumerate(_by_w(runs, W)):
        own = [f"sphere-{s}.reg.surf.gii" for s in range(r * per,
                                                          (r + 1) * per)]
        own += [f"transformed_and_reprojected-{s}.func.gii"
                for s in range(r * per, (r + 1) * per)]
        want = own + (group_files if r == 0 else [])
        assert out["gmsm", W]["written"] == sorted(
            f"gmsm_W{W}_of{W}_{name}" for name in want), r
    files = os.listdir(runs["dir"])
    for name in group_files:
        assert f"gmsm_W{W}_of{W}_{name}" in files


def test_run_gmsm_given_no_group_is_one_rank_under_a_process_group(runs):
    """With the process group up, run_gmsm(group=None) is one rank on
    every rank: the same result, and each rank writes every file."""
    one = runs["four"][0]["gmsm", 1]
    for r, out in enumerate(runs["four"]):
        got = out["gmsm", 1]
        _assert_same(dict(got, written=one["written"]), one, f"rank {r}")
        assert len(got["written"]) == 3 * S + 2
        assert all(f.startswith(f"gmsm_W1_of4_r{r}_") for f in got["written"])
    files = os.listdir(runs["dir"])
    assert all(f"gmsm_W1_of4_r{r}_mean.func.gii" in files for r in range(4))


@pytest.mark.parametrize("W", [2, 4])
def test_run_cgmsm_is_bitwise_that_of_one_rank(runs, W):
    """The whole state {group: members, meshes, mean} of W ranks, the
    nodes on 2 ranks (a sub-group at W = 4), equals the one-rank state on
    every rank; the root holds every subject."""
    one = runs["four"][0]["cgmsm", 1]
    assert one["ABC"]["members"] == ["s0", "s1", "s2", "s3"]
    for r, out in enumerate(_by_w(runs, W)):
        _assert_same(out["cgmsm", W], one, f"W {W} rank {r}")


def test_run_cohort_over_four_ranks_is_the_one_rank_cgmsm(runs):
    """run_cohort(group=WORLD) on the same tree: bitwise the one-rank
    run_cgmsm state on every rank."""
    one = runs["four"][0]["cgmsm", 1]
    for r, out in enumerate(runs["four"]):
        assert out["cohort"]["tree"] == TREE
        _assert_same(out["cohort"]["state"], one, f"rank {r}")


def test_host_array_collectives(runs):
    """all_gather_arrays: every rank's arrays in rank order, with their
    dtypes and shapes, bit for bit (pi as float32, -0.0 included);
    broadcast_arrays from rank 1; share() covers 3 items once."""
    for group in ("four", "two"):
        outs = [o["collectives"] for o in runs[group]]
        world = len(outs)
        want = []
        for r in range(world):
            want += [np.arange(r + 1, dtype=np.float64) / 3.0,
                     np.full((2, r), r, np.int32)][:1 + r % 2]
            if r == 0:
                want.append(np.array([[np.pi, -0.0]], np.float32))
        for r, got in enumerate(outs):
            _assert_same(got["gathered"], want, f"{group} rank {r}")
            assert np.signbit(got["gathered"][1][0, 1])
            _assert_same(got["bcast"], [np.arange(2.0) / 3.0,
                                        np.full((2, 1), 1, np.int32)],
                         f"{group} rank {r}")
        assert sum((o["share"] for o in outs), []) == [0, 1, 2]


def test_for_subjects_picks_the_largest_dividing_rank_count(runs):
    """S = 1..4 over 4 ranks: the first n ranks, n the largest count <= 4
    that divides S (4, 3 via a new group, 2 via a new group, 1 alone), None
    elsewhere, and the same group again on a second call; a group that
    does not span the world is refused."""
    outs = [o["collectives"] for o in runs["four"]]
    for n_subjects, n in ((1, 1), (2, 2), (3, 3), (4, 4)):
        got = [o["for", n_subjects] for o in outs]
        assert got == [(n, r) if r < n else None for r in range(4)], got
        assert all(o["kept", n_subjects] for o in outs)
    assert [o["refused"] for o in outs[:3]] == [True] * 3
    two = [o["collectives"] for o in runs["two"]]
    assert [o["for", 2] for o in two] == [(2, 0), (2, 1)]
    assert [o["for", 1] for o in two] == [(1, 0), None]


def test_run_gmsm_over_four_ranks_matches_the_jax_package(runs):
    """The port's run_gmsm at W = 4 from the JAX package's fusion starts
    against the JAX package's run_gmsm on 4 virtual CPU devices: first
    energy rtol 1e-3, CC within 0.02, the same stats keys; and bitwise the
    same on every rank."""
    jres, (devices, jlog) = runs["jax"]
    assert devices == 4
    got = runs["four"][0]["from_starts"]
    for r, out in enumerate(runs["four"]):
        _assert_same(out["from_starts"], got, f"rank {r}")
    np.testing.assert_allclose(got["energies"][0][2], jlog[0][2], rtol=1e-3)
    assert set(got["stats"]) == set(jres.stats)
    assert abs(got["stats"]["cc"] - jres.stats["cc"]) <= 0.02, (
        got["stats"], jres.stats)
    assert got["mean"].shape == jres.mean_map.shape
