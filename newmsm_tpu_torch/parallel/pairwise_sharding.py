"""Multi-GPU pairwise registration: cost-volume rows sharded over ranks.
Port of newmsm_tpu/parallel/pairwise_sharding.py.

The pairwise MRF has no subject axis; its scale-out axes are the
cost-volume rows: control-point vertices for the unary (K,L) volume and CP
faces for the triplet (T,L^3) volume. Both are row-parallel: each rank of
a process group (parallel/multihost.SubjectComm) computes a contiguous
row range with the small source / target tables replicated, and the ranks'
rows are all-gathered; there is no halo, because patches gather from the
replicated source arrays.

Reference counterpart: the OpenMP `parallel for` over CP vertices and
triplets (DiscreteCostFunction.cpp:240,246); here the threads are ranks.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..reg import costs as C
from .multihost import SubjectComm


def pad_rows(arr, n_shards: int, fill=None):
    """Pad the leading axis to a multiple of n_shards (equal row ranges;
    K = 642 etc. are not multiples of 8). Padding repeats the last row
    unless `fill` is given."""
    pad = (-arr.shape[0]) % n_shards
    if pad == 0:
        return arr
    tail = (arr[-1:].expand((pad,) + arr.shape[1:]) if fill is None
            else torch.full((pad,) + arr.shape[1:], fill, dtype=arr.dtype,
                            device=arr.device))
    return torch.cat([arr, tail])


def _my_rows(comm: SubjectComm, n: int) -> slice:
    per = n // comm.world
    return slice(comm.rank * per, (comm.rank + 1) * per)


def make_sharded_unary(comm: Optional[SubjectComm], tables, src_data,
                       tgt_data, cfweights, simval: int, mode: str, pmax: int,
                       cprange: float, percentile: float = 0.75):
    """CP-row-sharded unary cost volume over the ranks of `comm` (None: one
    rank). Closes over the replicated statics (search tables, feature
    data). The returned fn(cp_coords (K,3), labels (L,3), centre (3,),
    maxsep (K,), abs_weights (K,), src_coords (N,3)) -> (K,L), on every
    rank, is reg.costs.unary_costs on reg.costs.build_patches' patches."""
    comm = comm or SubjectComm()

    def fn(cp_coords, labels, centre, maxsep, abs_weights, src_coords):
        K = cp_coords.shape[0]
        rows = _my_rows(comm, K + (-K) % comm.world)
        cp_loc = pad_rows(cp_coords, comm.world)[rows]
        _, rl = C.rotated_label_positions(cp_loc, labels, centre)
        patch_idx, patch_mask, _ = C.build_patches(
            cp_loc, src_coords, pad_rows(maxsep, comm.world)[rows], cprange,
            pmax)
        out = C.unary_costs(
            cp_loc, rl, src_coords, patch_idx, patch_mask, tables, src_data,
            tgt_data, cfweights,
            pad_rows(abs_weights, comm.world, fill=0.0)[rows],
            simval=simval, percentile=percentile, mode=mode)
        return comm.all_gather(out)[:K]

    return fn


def make_sharded_triplet_volume(comm: Optional[SubjectComm], reglambda, mu,
                                kappa, k_exp, rexp):
    """Face-row-sharded (T,L,L,L) strain cost volume over the ranks of
    `comm` (None: one rank): fn(rl (K,L,3) replicated, triplets (T,3), cur
    (T,3,3), orig (T,3,3)) -> (T,L,L,L) on every rank,
    reg.costs.triplet_volume_arrays on each rank's faces."""
    comm = comm or SubjectComm()

    def fn(rl, triplets, cur, orig):
        T, L = triplets.shape[0], rl.shape[1]
        rows = _my_rows(comm, T + (-T) % comm.world)
        out = C.triplet_volume_arrays(
            rl, pad_rows(triplets, comm.world)[rows],
            pad_rows(cur, comm.world)[rows], pad_rows(orig, comm.world)[rows],
            reglambda, mu, kappa, k_exp, rexp)
        return comm.all_gather(out.reshape(-1, L, L, L))[:T]

    return fn
