"""Ranks and collectives for the subject-sharded groupwise path, over
torch.distributed. Port of newmsm_tpu/parallel/multihost.py.

One process per rank, each rank with one explicit device. The subject axis
spans the ranks: rank r owns the contiguous subject range
process_subject_slice(S) (ranks of one node are contiguous under torchrun
and SLURM, so consecutive subjects share a node). There is no global-array
object in torch: each rank holds its local slice, and the groupwise
optimiser combines the ranks' work through a SubjectComm.

    python -m torch.distributed.run --standalone --nproc_per_node=W \\
        -m newmsm_tpu_torch.cli --groupwise ... [--device cpu] \\
        [--dist-backend gloo|nccl]

initialize() reads torchrun's RANK / WORLD_SIZE / LOCAL_RANK /
MASTER_ADDR / MASTER_PORT, or SLURM's SLURM_PROCID / SLURM_NTASKS /
SLURM_LOCALID with MASTER_ADDR / MASTER_PORT set by the job script. In one
process without them it does nothing. run_local_ranks() starts W ranks on
this host from Python (a FileStore rendezvous, no port).
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist

# set when initialize() brought the process group up (shutdown() ends it)
_initialized_here = False


# --------------------------------------------------------------------------
# rank environment and process group
# --------------------------------------------------------------------------

def env_ranks():
    """(rank, world, local_rank, local_world) from torchrun's or SLURM's
    variables, or None in a plain single process."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        world = int(env["WORLD_SIZE"])
        return (int(env["RANK"]), world, int(env.get("LOCAL_RANK", 0)),
                int(env.get("LOCAL_WORLD_SIZE", world)))
    if int(env.get("SLURM_NTASKS", "1")) > 1 and "SLURM_PROCID" in env:
        world = int(env["SLURM_NTASKS"])
        per_node = env.get("SLURM_NTASKS_PER_NODE", str(world))
        return (int(env["SLURM_PROCID"]), world,
                int(env.get("SLURM_LOCALID", 0)),
                int(per_node.split("(")[0].split(",")[0]))
    return None


def choose_backend(device, local_world: int, n_cards: int) -> str:
    """The backend for `device` when none was named: gloo on the CPU, nccl
    on CUDA when every local rank has a card of its own. Ranks that share a
    card need gloo (NCCL refuses two ranks on one card), and that is never
    chosen silently: this raises."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"no collective backend for device {str(device)!r}")
    if local_world > n_cards:
        raise RuntimeError(
            f"{local_world} ranks on this node share {n_cards} CUDA card(s): "
            "NCCL needs a card per rank. Pass --dist-backend gloo "
            "(initialize(backend='gloo')) to run them on shared cards")
    return "nccl"


def initialize(backend: str | None = None, device="cuda") -> None:
    """Bring up the default process group from the environment (see the
    module docstring). Idempotent, and a no-op in one process without rank
    variables. backend None: choose_backend(device, ...)."""
    global _initialized_here
    if dist.is_initialized():
        return
    ranks = env_ranks()
    if ranks is None:
        return
    rank, world, local_rank, local_world = ranks
    device = torch.device(device)
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if backend is None:
        backend = choose_backend(device, local_world, n_cards)
    for name in ("MASTER_ADDR", "MASTER_PORT"):
        if name not in os.environ:
            raise RuntimeError(f"{name} must be set to bring up {world} ranks")
    if device.type == "cuda":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    _initialized_here = True


def shutdown() -> None:
    """End the process group that initialize() brought up."""
    global _initialized_here
    if _initialized_here and dist.is_initialized():
        dist.destroy_process_group()
    _initialized_here = False
    _SUB_GROUPS.clear()


def rank_device(device="cuda") -> torch.device:
    """This rank's device: cuda:{LOCAL_RANK % device_count} for a CUDA
    device without an index under rank variables, else `device` as given."""
    device = torch.device(device)
    ranks = env_ranks()
    if device.type != "cuda" or device.index is not None or ranks is None:
        return device
    return torch.device("cuda", ranks[2] % max(1, torch.cuda.device_count()))


def ranks_on_device(device) -> int:
    """How many of this node's ranks share `device`'s memory: on CUDA the
    local ranks that rank_device() puts on its card, on the CPU every local
    rank (host memory); 1 without rank variables."""
    ranks = env_ranks()
    if ranks is None:
        return 1
    local_world = ranks[3]
    device = torch.device(device)
    if device.type != "cuda":
        return local_world
    n = max(1, torch.cuda.device_count())
    card = (device.index if device.index is not None
            else torch.cuda.current_device())
    return sum(1 for r in range(local_world) if r % n == card)


def free_bytes(device) -> int:
    """Free memory of `device`: the card's (cudaMemGetInfo) on CUDA, the
    host's free physical pages on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def process_subject_slice(n_subjects: int, comm=None) -> slice:
    """The contiguous subject range this rank owns; rank r of W owns
    [r*S/W, (r+1)*S/W). Raises when W does not divide S. comm None:
    default_comm()."""
    comm = comm or default_comm()
    if n_subjects % comm.world:
        raise ValueError(
            f"n_subjects={n_subjects} must be divisible by the rank count "
            f"{comm.world} for subject sharding (pad the cohort or use fewer "
            "ranks); refusing to silently drop the remainder subjects")
    per = n_subjects // comm.world
    return slice(comm.rank * per, (comm.rank + 1) * per)


def share(n_items: int, comm=None) -> range:
    """This rank's contiguous share of n_items independent jobs: rank r of
    W takes [r*n/W, (r+1)*n/W), rounded down, so any n works and a share
    may be empty. For per-item work whose results are all-gathered in item
    order (the pipelines' per-subject resamples), where no batch spans two
    items and so the split cannot change a bit. comm None: default_comm()."""
    comm = comm or default_comm()
    return range(comm.rank * n_items // comm.world,
                 (comm.rank + 1) * n_items // comm.world)


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

# the sub-groups of for_subjects, one per (default group, ranks): every
# rank calls new_group once for each, so NCCL communicators do not pile up
# over repeated pipeline runs
_SUB_GROUPS: dict = {}


def default_comm() -> "SubjectComm":
    """The default process group's SubjectComm when the group is up, else
    one rank's."""
    return SubjectComm(dist.group.WORLD if dist.is_initialized() else None)


class SubjectComm:
    """The collectives of the subject-sharded optimiser on one explicit
    process group; group None is one rank, where every collective is the
    identity. Every rank of the group must make the same calls in the same
    order."""

    def __init__(self, group=None):
        self.group = group
        if group is None:
            self.world, self.rank, self.backend = 1, 0, None
        else:
            self.world = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            self.backend = dist.get_backend(group)
            if self.rank < 0:
                raise ValueError("this process is not a member of the group")

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Tiled all-gather of subject-major tensors: the ranks' (n,...)
        blocks concatenated in rank order along dim 0."""
        if self.world == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)

    def all_gather_arrays(self, arrays) -> list:
        """Every rank's list of host (numpy) arrays, concatenated in rank
        order; ranks may hold different numbers, shapes and dtypes. They
        travel pickled, so each comes back bit for bit."""
        if self.world == 1:
            return list(arrays)
        parts = [None] * self.world
        dist.all_gather_object(parts, list(arrays), group=self.group)
        return [a for part in parts for a in part]

    def broadcast_arrays(self, arrays, src: int = 0) -> list:
        """Rank `src`'s list of host arrays (as in all_gather_arrays), on
        every rank; the other ranks' `arrays` are ignored."""
        if self.world == 1:
            return list(arrays)
        box = [list(arrays) if self.rank == src else None]
        dist.broadcast_object_list(
            box, src=dist.get_global_rank(self.group, src), group=self.group)
        return box[0]

    def for_subjects(self, n_subjects: int) -> "SubjectComm | None":
        """The comm of this group's first n ranks, n the largest rank count
        <= W that divides n_subjects (the JAX package's single-process
        choice of devices, newmsm_tpu/reg/group.py:297-316); None on the
        ranks outside it, which wait for the result (broadcast_arrays from
        rank 0). Only for a pipeline that must register an S it did not
        choose, such as the 2-subject nodes of cgMSM: where the user
        chooses W (the CLI under torchrun) process_subject_slice refuses a
        W that does not divide S. A smaller group comes from
        dist.new_group, which every rank of the default group must call in
        the same order, so then this comm must span the default group; it
        is made once per set of ranks and kept for later calls."""
        n = min(self.world, n_subjects)
        while n_subjects % n:
            n -= 1
        if n == self.world:
            return self
        if n == 1:
            return SubjectComm() if self.rank == 0 else None
        if self.world != dist.get_world_size():
            raise ValueError(
                f"{n_subjects} subjects need a group of {n} of this comm's "
                f"{self.world} ranks, and a new group needs every rank of "
                "the default group: pass a group that spans the world")
        ranks = tuple(dist.get_global_rank(self.group, r) for r in range(n))
        key = (dist.group.WORLD, ranks)
        if key not in _SUB_GROUPS:
            _SUB_GROUPS[key] = dist.new_group(list(ranks))
        return SubjectComm(_SUB_GROUPS[key]) if self.rank < n else None

    def disjoint_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of tensors whose nonzero slots are disjoint across ranks:
        every slot is one rank's value plus exact zeros, so the result does
        not depend on the reduction order."""
        if self.world == 1:
            return t
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """Element-wise MAX over the ranks."""
        if self.world == 1:
            return t
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """The ring's neighbour exchange: send `t` to rank+1, return the
        block received from rank-1 (ranks of the group, cyclic)."""
        if self.world == 1:
            return t
        # gloo's point-to-point calls take CPU tensors only: a CUDA block
        # travels through host memory under gloo (NCCL sends it directly)
        staged = self.backend == "gloo" and t.is_cuda
        send = t.detach().cpu() if staged else t.contiguous()
        recv = torch.empty_like(send)
        peer = (lambda r: dist.get_global_rank(self.group, r % self.world))
        ops = [dist.P2POp(dist.isend, send, peer(self.rank + 1), self.group),
               dist.P2POp(dist.irecv, recv, peer(self.rank - 1), self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv.to(t.device) if staged else recv


# --------------------------------------------------------------------------
# W local ranks from Python
# --------------------------------------------------------------------------

def _rank_main(fn, args, rank, world, backend, store_path, threads,
               timeout_s, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    try:
        if threads:
            torch.set_num_threads(threads)
        if backend == "nccl":
            torch.cuda.set_device(rank_device("cuda"))
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:       # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))


def run_local_ranks(fn, world: int, args=(), backend: str = "gloo",
                    timeout: float = 600.0, threads: int | None = None):
    """Run fn(*args) on `world` local ranks, each a fresh process (spawn)
    with the default process group up (`backend`, a FileStore rendezvous)
    and RANK / LOCAL_RANK / WORLD_SIZE set, so that rank_device() gives its
    device. Returns the ranks' return values in rank order. Raises if a
    rank raises or dies; kills every rank and raises TimeoutError after
    `timeout` seconds. `fn` must be importable by name (a module-level
    function) and its arguments and result picklable."""
    import multiprocessing as mp
    import time
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="newmsm_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, args, r, world, backend, os.path.join(tmp, "store"), threads,
        timeout, results)) for r in range(world)]
    try:
        for p in procs:
            p.start()
        out, deadline = {}, time.monotonic() + timeout
        while len(out) < world:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish in "
                                   f"{timeout} s (ranks done: {sorted(out)})")
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out
                        and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} died with exit codes "
                                       f"{[procs[r].exitcode for r in dead]}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
