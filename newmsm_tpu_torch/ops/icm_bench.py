"""Binary-ICM problems at the shapes of the fusion paths, the comparison of
K2 (csrc/icm_binary.cu) with its plain version, and their times on the
card (`time_move` at `SHAPES`: the ico-4 strain shape, K = 2,562, and the
gmsm_s8 last-level shape, S = 8 subjects of K = 2,562, N = 20,496; 5
starts, 4 passes). chip_smoke.py and tests/test_torch_cuda.py build their
problems here.

A problem is the argument tuple of ops/icm.py::icm_binary:
(x, u0, u1, t8, triplets, tables, passes, p4, pairs), in one of the three
forms the callers pass: 't8' (the triplet paths), 'p4' (regoption 1's
pairs) and 'group' (t8 + p4 over S subjects, zero unaries). With
`integer` the tables hold small integers, so every sum is exact in float32
and the order of a sum cannot show.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..core.icosphere import icosphere
from ..reg.optimise import fusion as FU
from . import icm

STARTS = 5          # keep-all, switch-all, greedy and 2 random restarts
PASSES = 4
# device-side sleep a timed launch queues behind (clocks; 200 us at the
# H100's 1,980 MHz, several times the host's cost of one launch)
HOLD_CYCLES_A_LAUNCH = 400_000


def _values(rng, shape, integer: bool) -> np.ndarray:
    if integer:
        return rng.integers(-8, 9, shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _starts(rng, u0, u1, n: int, device) -> torch.Tensor:
    x = np.stack([np.zeros(n), np.ones(n), (u1 < u0)]
                 + [rng.integers(0, 2, n) for _ in range(STARTS - 3)])
    return torch.from_numpy(x.astype(np.int64)).to(device)


def _edges(faces: np.ndarray) -> np.ndarray:
    e = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                                faces[:, [0, 2]]]), axis=1)
    return np.unique(e, axis=0).astype(np.int64)


def pairwise_problem(res: int, form: str, device, seed: int = 0,
                     integer: bool = False) -> tuple:
    """A move on the ico-`res` control grid: form 't8' (its faces as
    triplets) or 'p4' (its edges as pairs), the fusion tables
    build_fusion_tables gives the driver."""
    ico = icosphere(res)
    K = ico.nvertices
    rng = np.random.default_rng(seed)
    faces = np.sort(ico.faces.astype(np.int64), axis=1)
    u0, u1 = _values(rng, K, integer), _values(rng, K, integer)
    dev = torch.device(device)

    def put(a):
        return torch.from_numpy(a).to(dev)

    if form == "t8":
        tables = FU.build_fusion_tables(faces, K, dev)
        t8, p4, trip, pairs = (put(_values(rng, (len(faces), 8), integer)),
                               None, put(faces), None)
    elif form == "p4":
        edges = _edges(faces)
        tables = FU.build_fusion_tables(np.zeros((0, 3), np.int64), K, dev,
                                        pairs=edges)
        t8, p4 = None, put(_values(rng, (len(edges), 4), integer))
        trip, pairs = put(np.zeros((0, 3), np.int64)), put(edges)
    else:
        raise ValueError(f"unknown pairwise form {form!r}")
    return (_starts(rng, u0, u1, K, dev), put(u0), put(u1), t8, trip, tables,
            PASSES, p4, pairs)


def group_problem(S: int, res: int, device, seed: int = 0,
                  integer: bool = False) -> tuple:
    """A group alpha step over S subjects of the ico-`res` control grid:
    a near-identity partner map (a tenth of the entries another vertex),
    the iteration tables of build_iteration_tables, the node triplets and
    pair endpoints GroupFusion builds, zero unaries."""
    from ..parallel import group_fusion as GF
    ico = icosphere(res)
    K = ico.nvertices
    N = S * K
    rng = np.random.default_rng(seed)
    faces = np.sort(ico.faces.astype(np.int64), axis=1)
    partner = np.broadcast_to(np.arange(K), (S, S, K)).copy()
    moved = rng.random(partner.shape) < 0.1
    partner[moved] = rng.integers(0, K, int(moved.sum()))
    dev = torch.device(device)
    tables = GF.build_iteration_tables(partner, faces, S, K, dev)
    blocks = GF.pair_blocks(S).astype(np.int64)
    a, b = blocks[:, 0], blocks[:, 1]
    pairs = np.stack([(a[:, None] * K + np.arange(K)).ravel(),
                      (b[:, None] * K + partner[a, b]).ravel()], 1)
    trip = (faces[None] + (np.arange(S) * K)[:, None, None]).reshape(-1, 3)
    zero = np.zeros(N, np.float32)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    t8 = put(_values(rng, (len(trip), 8), integer))
    p4 = put(_values(rng, (len(pairs), 4), integer))
    return (_starts(rng, zero, zero, N, dev), put(zero), put(zero), t8,
            put(trip), tables, PASSES, p4, put(pairs))


def twin(problem) -> tuple:
    """The plain version on a copy of the starts: (xs, es)."""
    x, *rest = problem
    return icm.icm_binary_twin(x.clone(), *rest)


def kernel(problem) -> tuple:
    """One launch of K2 on a copy of the starts: (xs, es)."""
    x, *rest = problem
    return icm.icm_binary(x.clone(), *rest)


def barrier_chain(problem) -> int:
    """Dependent colour steps of one move: passes x colours."""
    return problem[6] * len(problem[5].groups)


def compare(problem) -> dict:
    """K2 against the plain version on one problem: rows of x that differ,
    largest relative energy gap, whether the chosen start (first minimum)
    and its x agree, and whether two launches repeat each other bit for
    bit."""
    xk, ek = kernel(problem)
    xk2, ek2 = kernel(problem)
    xt, et = twin(problem)
    ik, it = int(torch.argmin(ek)), int(torch.argmin(et))
    gap = ((ek.double() - et.double()).abs()
           / et.double().abs().clamp(min=1e-30)).max()
    return {"rows_differ": int((xk != xt).any(1).sum()),
            "es_equal": bool(torch.equal(ek, et)),
            "xs_equal": bool(torch.equal(xk, xt)),
            "energy_rel_gap": float(gap),
            "chosen_same": ik == it and bool(torch.equal(xk[ik], xt[it])),
            "repeats": bool(torch.equal(xk, xk2) and torch.equal(ek, ek2))}


def floor_problems(problem) -> dict:
    """The same launch with the work of a step taken away, for the floor
    under K2's time: 'barrier' keeps the passes x colours chain of cluster
    barriers with every colour group empty; 'gather' keeps the colour
    groups and drops the tables, so a node's step is one dependent gather
    (its id, then its unaries) and the stores of its bit."""
    x, u0, u1, _, _, tables, passes, _, _ = problem
    groups = tables.groups
    barrier = SimpleNamespace(
        color_ids=tables.color_ids[:0],
        color_offsets=torch.zeros_like(tables.color_offsets), groups=groups)
    gather = SimpleNamespace(color_ids=tables.color_ids,
                             color_offsets=tables.color_offsets,
                             groups=groups)
    return {name: (x, u0, u1, None, None, t, passes, None, None)
            for name, t in (("barrier", barrier), ("gather", gather))}


def time_move(problem, launches: int = 50) -> dict:
    """Milliseconds a move of the kernel and of the plain version on the
    card (windows between CUDA events), and of the kernel's floors
    (`floor_problems`). The kernel's windows queue behind a device-side
    sleep (`time_launches`' hold_cycles), so each is the card's time and
    not the host's launch rate, which `host_launch_ms` gives: the barrier
    floor's launches back to back without the hold. The kernel's launches
    descend in place, each from the last one's result: a launch runs every
    pass and colour step whatever x holds, so its work does not change."""
    from .locate_bench import time_launches
    work = problem[0].clone()
    hold = launches * HOLD_CYCLES_A_LAUNCH

    def kernel_ms(p, hold_cycles=hold):
        return time_launches(lambda: icm.icm_binary(work, *p[1:]), windows=5,
                             launches=launches, warmup=10,
                             hold_cycles=hold_cycles)
    k = kernel_ms(problem)
    bare = floor_problems(problem)
    floors = {name: kernel_ms(p)["ms"] for name, p in bare.items()}
    host = kernel_ms(bare["barrier"], 0)["ms"]
    p = time_launches(lambda: twin(problem), windows=3, launches=5, warmup=2)
    steps = barrier_chain(problem)
    return {"kernel_ms": k["ms"], "kernel_ms_spread": k["ms_spread"],
            "plain_ms": p["ms"], "barrier_chain": steps,
            "barrier_floor_ms": floors["barrier"],
            "gather_floor_ms": floors["gather"], "host_launch_ms": host,
            "barrier_step_us": 1e3 * floors["barrier"] / steps,
            "gather_step_us": 1e3 * floors["gather"] / steps,
            "kernel_step_us": 1e3 * k["ms"] / steps,
            "floor_share": floors["gather"] / k["ms"],
            "nodes": int(work.shape[1]), "starts": int(work.shape[0])}


SHAPES = {"strain_ico4": lambda dev: pairwise_problem(4, "t8", dev),
          "gmsm_s8_last_level": lambda dev: group_problem(8, 4, dev)}

