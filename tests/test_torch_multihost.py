"""newmsm_tpu_torch.parallel.multihost on the CPU: the rank environment,
the backend choice, the subject slice, the collectives of SubjectComm on
real gloo ranks (run_local_ranks: a FileStore rendezvous, no port), a
failing and a hung rank, and the group CLI under torchrun at W = 2 against
one process. Rank workers are module-level functions, and this module
imports neither JAX nor the JAX package at its top: spawned ranks import it
by name."""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from newmsm_tpu_torch.parallel import multihost as mh

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANK_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
             "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID",
             "SLURM_NTASKS_PER_NODE", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def no_rank_env(monkeypatch):
    for name in RANK_VARS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_env_ranks_reads_torchrun_then_slurm(no_rank_env):
    env = no_rank_env
    assert mh.env_ranks() is None
    env.setenv("SLURM_NTASKS", "1")             # a one-task job: no ranks
    env.setenv("SLURM_PROCID", "0")
    assert mh.env_ranks() is None
    env.setenv("SLURM_NTASKS", "8")
    env.setenv("SLURM_PROCID", "5")
    env.setenv("SLURM_LOCALID", "1")
    env.setenv("SLURM_NTASKS_PER_NODE", "4(x2)")
    assert mh.env_ranks() == (5, 8, 1, 4)
    env.setenv("RANK", "3")                     # torchrun's variables win
    env.setenv("WORLD_SIZE", "4")
    env.setenv("LOCAL_RANK", "1")
    env.setenv("LOCAL_WORLD_SIZE", "2")
    assert mh.env_ranks() == (3, 4, 1, 2)


def test_backend_choice_never_puts_two_ranks_on_a_card_silently():
    assert mh.choose_backend("cpu", 4, 0) == "gloo"
    assert mh.choose_backend("cuda", 2, 2) == "nccl"
    assert mh.choose_backend("cuda:0", 1, 8) == "nccl"
    with pytest.raises(RuntimeError, match="--dist-backend gloo"):
        mh.choose_backend("cuda", 2, 1)


def test_initialize_is_a_noop_in_one_process(no_rank_env):
    mh.initialize()
    mh.initialize(device="cpu")
    assert not dist.is_initialized()
    assert mh.default_comm().world == 1
    mh.shutdown()


def test_rank_device_keeps_what_was_asked(no_rank_env):
    assert mh.rank_device("cpu") == torch.device("cpu")
    assert mh.rank_device("cuda:1") == torch.device("cuda", 1)
    assert mh.rank_device("cuda") == torch.device("cuda")
    no_rank_env.setenv("RANK", "1")
    no_rank_env.setenv("WORLD_SIZE", "2")
    no_rank_env.setenv("LOCAL_RANK", "1")
    assert mh.rank_device("cpu") == torch.device("cpu")
    assert mh.rank_device("cuda:0") == torch.device("cuda", 0)
    assert mh.rank_device("cuda").type == "cuda"


def test_ranks_on_device_counts_the_ranks_that_share_its_memory(no_rank_env):
    assert mh.ranks_on_device("cpu") == 1
    for name, value in (("RANK", "2"), ("WORLD_SIZE", "8"),
                        ("LOCAL_RANK", "2"), ("LOCAL_WORLD_SIZE", "4")):
        no_rank_env.setenv(name, value)
    assert mh.ranks_on_device("cpu") == 4           # host memory: all local
    assert mh.free_bytes("cpu") > 0


def test_auto_maps_exchange_follows_the_free_memory(no_rank_env):
    """choose_maps_exchange: 'gather' while the gathered maps of every rank
    on the device take at most half its free memory, else 'ring'."""
    from newmsm_tpu_torch.reg import group
    no_rank_env.setattr(mh, "free_bytes", lambda device: 1000)
    one = mh.SubjectComm()
    assert group.choose_maps_exchange(500, "cpu", one) == "gather"
    assert group.choose_maps_exchange(501, "cpu", one) == "ring"
    no_rank_env.setenv("RANK", "0")
    no_rank_env.setenv("WORLD_SIZE", "2")
    no_rank_env.setenv("LOCAL_WORLD_SIZE", "2")     # two ranks on the host
    assert group.choose_maps_exchange(250, "cpu", one) == "gather"
    assert group.choose_maps_exchange(251, "cpu", one) == "ring"


def _exchange_rank():
    from newmsm_tpu_torch.reg import group
    mh.free_bytes = lambda device: 1000 if dist.get_rank() == 0 else 10 ** 9
    return group.choose_maps_exchange(300, "cpu", mh.default_comm())


def test_auto_maps_exchange_is_the_same_on_every_rank():
    """Rank 0 alone is short of memory: both ranks choose 'ring'."""
    assert mh.run_local_ranks(_exchange_rank, 2, timeout=120,
                              threads=1) == ["ring", "ring"]


class _Comm:
    def __init__(self, world, rank):
        self.world, self.rank = world, rank


def test_process_subject_slice_is_contiguous_and_refuses_remainders():
    assert mh.process_subject_slice(6) == slice(0, 6)
    assert [mh.process_subject_slice(8, _Comm(4, r)) for r in range(4)] == \
        [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="divisible"):
        mh.process_subject_slice(6, _Comm(4, 1))


def test_one_rank_collectives_are_the_identity():
    comm = mh.SubjectComm()
    t = torch.arange(6.0).reshape(3, 2)
    for op in (comm.all_gather, comm.disjoint_sum, comm.max,
               comm.ring_shift):
        assert torch.equal(op(t), t)
    assert (comm.world, comm.rank, comm.backend) == (1, 0, None)


def _collectives_rank():
    comm = mh.default_comm()
    r, w = comm.rank, comm.world
    own = torch.full((2, 3), float(r))
    slots = torch.zeros(w, 2)
    slots[r] = torch.tensor([r + 0.5, -(r + 0.25)])
    return dict(
        rank=r, world=w, backend=comm.backend,
        gathered=comm.all_gather(own).numpy(),
        summed=comm.disjoint_sum(slots).numpy(),
        maxed=comm.max(torch.tensor([r, -r], dtype=torch.int64)).numpy(),
        shifted=comm.ring_shift(own).numpy(),
        twice=comm.ring_shift(comm.ring_shift(own)).numpy(),
        slice=mh.process_subject_slice(6))


def test_collectives_on_three_gloo_ranks():
    """Tiled all-gather in rank order, the disjoint-slot sum (each slot
    exact), MAX, and the ring exchange (rank r receives rank r-1's block)
    with an odd rank count."""
    out = mh.run_local_ranks(_collectives_rank, 3, timeout=120, threads=1)
    for r, o in enumerate(out):
        assert (o["rank"], o["world"], o["backend"]) == (r, 3, "gloo")
        np.testing.assert_array_equal(
            o["gathered"], np.repeat(np.arange(3.0), 2)[:, None] * np.ones(3))
        np.testing.assert_array_equal(
            o["summed"], [[k + 0.5, -(k + 0.25)] for k in range(3)])
        np.testing.assert_array_equal(o["maxed"], [2, 0])
        np.testing.assert_array_equal(o["shifted"], np.full((2, 3), (r - 1) % 3))
        np.testing.assert_array_equal(o["twice"], np.full((2, 3), (r - 2) % 3))
        assert o["slice"] == slice(2 * r, 2 * r + 2)


def _failing_rank():
    if dist.get_rank() == 1:
        raise ValueError("rank one refuses")
    return "fine"


def _hung_rank():
    if dist.get_rank() == 1:
        time.sleep(600)
    dist.barrier()


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank one refuses"):
        mh.run_local_ranks(_failing_rank, 2, timeout=120, threads=1)


def test_a_hung_rank_is_killed_at_the_timeout():
    t0 = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError)):
        mh.run_local_ranks(_hung_rank, 2, timeout=15, threads=1)
    assert time.monotonic() - t0 < 60


CLI_CONFIG = """\
--opt=DISCRETE
--simval=2
--it=2
--sigma_in=0
--sigma_ref=0
--lambda=0.1
--datagrid=2
--CPgrid=1
--SGgrid=2
--dopt=HOCR
--regoption=3
--cprange=1.1
"""


def test_group_cli_under_torchrun_equals_one_process(tmp_path):
    """`python -m torch.distributed.run --standalone --nproc_per_node=2 -m
    newmsm_tpu_torch.cli --groupwise ... --device cpu` on 4 ico-2 subjects:
    every subject's sphere and map written, `devices` 2 in every iter
    event, one line an event, and energies and spheres bitwise those of
    the same CLI in one process."""
    from newmsm_tpu_torch import cli as tcli
    from newmsm_tpu_torch.core.mesh import Mesh
    from newmsm_tpu_torch.eval.synth import synth_cohort
    meshes, datasets, _ = synth_cohort(2, 4, seed=1, warp_deg=6.0)
    d = tmp_path
    for s, (m, data) in enumerate(zip(meshes, datasets)):
        m.save(str(d / f"s{s}.surf.gii"))
        Mesh(coords=m.coords, faces=m.faces, data=data).save(
            str(d / f"s{s}.func.gii"))
    (d / "meshes.txt").write_text(
        "".join(f"{d}/s{s}.surf.gii\n" for s in range(4)))
    (d / "data.txt").write_text(
        "".join(f"{d}/s{s}.func.gii\n" for s in range(4)))
    Mesh.from_icosphere(2).save(str(d / "template.surf.gii"))
    (d / "conf").write_text(CLI_CONFIG)
    args = ["--groupwise", "--meshes", str(d / "meshes.txt"), "--data",
            str(d / "data.txt"), "--template", str(d / "template.surf.gii"),
            "--conf", str(d / "conf"), "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    for name in RANK_VARS:
        env.pop(name, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "newmsm_tpu_torch.cli", *args,
         "-o", str(d / "w2_"), "--metrics", str(d / "w2_m.jsonl")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)              # as each torchrun rank
    try:
        assert tcli.main([*args, "-o", str(d / "w1_"), "--metrics",
                          str(d / "w1_m.jsonl")]) == 0
    finally:
        torch.set_num_threads(threads)
    ev = {w: [json.loads(line) for line in open(d / f"{w}_m.jsonl")]
          for w in ("w1", "w2")}
    iters = {w: [e for e in ev[w] if e["event"] == "iter"] for w in ev}
    assert len(iters["w2"]) == 2
    assert [e["devices"] for e in iters["w2"]] == [2, 2]
    assert all(len(e["setup_s_by_rank"]) == 2 for e in iters["w2"])
    assert [e["event"] for e in ev["w2"]].count("outputs") == 1
    ranks = [e for e in ev["w2"] if e["event"] == "ranks"]
    assert len(ranks) == 1 and len(ranks[0]["locate_launches"]) == 2
    assert [e["energy"] for e in iters["w2"]] == \
        [e["energy"] for e in iters["w1"]]
    for s in range(4):
        a = Mesh.load(str(d / f"w2_sphere-{s}.reg.surf.gii"))
        b = Mesh.load(str(d / f"w1_sphere-{s}.reg.surf.gii"))
        np.testing.assert_array_equal(a.coords, b.coords)
        assert (d / f"w2_transformed_and_reprojected-{s}.func.gii").exists()
