"""Binary ICM of one fusion move: the wrapper of the hand-written CUDA
kernel csrc/icm_binary.cu (K2), which replaces no TPU kernel (the JAX
package runs the loop inside one XLA program), and its plain PyTorch
version, the twin `icm_binary_twin` (`_binary_icm` + `binary_energy`).
`icm_binary` picks one by device (ops/_build.py, `Kernel.run`).
"""
from __future__ import annotations

import torch

from . import _build

SOURCE = "icm_binary.cu"
KERNEL = "icm_binary_kernel"      # name of the __global__ template
P, I, L = _build.PTR, _build.INT, _build.LONG
SEAM = _build.Kernel("icm", SOURCE, "icm_binary", "k2.load", {
    "icm_binary_launch": ([P, P, I, I, P, P, P, P, P, P, I, L, P, P, P, P,
                           I, L, P, P, I, I, P], I)})


def _table_sum(table, idx):
    """sum_r table[r, idx[..., r]] for idx (...,R) -> (...)."""
    return torch.gather(table.expand(idx.shape + table.shape[-1:]), -1,
                        idx[..., None])[..., 0].sum(-1)


def binary_energy(x, u0, u1, t8, triplets, p4=None, pairs=None):
    """Binary-subproblem energy at x (...,K) (0=keep, 1=switch) -> (...)."""
    e = torch.where(x == 1, u1, u0).sum(-1)
    if t8 is not None:
        xb = x[..., triplets]                           # (...,T,3)
        e = e + _table_sum(t8, xb[..., 0] * 4 + xb[..., 1] * 2 + xb[..., 2])
    if p4 is not None:
        xp = x[..., pairs]                              # (...,Pr,2)
        e = e + _table_sum(p4, xp[..., 0] * 2 + xp[..., 1])
    return e


def _own_bit(xb, pos):
    """xb (S,G,M,W) binary states, pos (G,M) own column -> (S,G,M)."""
    return torch.gather(xb, 3, pos[None, ..., None].expand(
        xb.shape[:3] + (1,)))[..., 0]


def _binary_icm(x, u0, u1, t8, triplets, tables, icm_passes: int, p4=None,
                pairs=None):
    """Exact parallel coordinate descent on the binary move energy from the
    starts x (S,K): colour groups flip together, each flip judged by its
    true local energy delta. Monotone non-increasing per start."""
    for _ in range(icm_passes):
        for nodes in tables.groups:
            delta = (u1[nodes] - u0[nodes])[None].expand(x.shape[0], -1)
            if t8 is not None:
                it = tables.vert_tri[nodes]             # (G,MT)
                pc = tables.vert_tri_corner[nodes]
                tmask = it >= 0
                it_s = it.clamp(min=0)
                xb = x[:, triplets[it_s]]               # (S,G,MT,3)
                base = xb[..., 0] * 4 + xb[..., 1] * 2 + xb[..., 2]
                w = torch.where(pc == 0, 4, torch.where(pc == 1, 2, 1))
                idx0 = base - _own_bit(xb, pc) * w
                idx1 = idx0 + w
                d_t = (t8[it_s, idx1] - t8[it_s, idx0]) * tmask
                delta = delta + d_t.sum(-1)
            if p4 is not None:
                ip = tables.vert_pair[nodes]            # (G,MP)
                pe = tables.vert_pair_end[nodes]
                pmask = ip >= 0
                ip_s = ip.clamp(min=0)
                xp = x[:, pairs[ip_s]]                  # (S,G,MP,2)
                wp = torch.where(pe == 0, 2, 1)
                i0 = xp[..., 0] * 2 + xp[..., 1] - _own_bit(xp, pe) * wp
                i1 = i0 + wp
                d_p = (p4[ip_s, i1] - p4[ip_s, i0]) * pmask
                delta = delta + d_p.sum(-1)
            x[:, nodes] = (delta < 0).to(x.dtype)
    return x


def icm_binary_twin(x, u0, u1, t8, triplets, tables, icm_passes: int,
                    p4=None, pairs=None):
    """The plain version, on any device: `_binary_icm` from the starts x
    (S,K), overwritten, and each result's `binary_energy`: (xs, es)."""
    xs = _binary_icm(x, u0, u1, t8, triplets, tables, icm_passes, p4, pairs)
    return xs, binary_energy(xs, u0, u1, t8, triplets, p4, pairs)


def check(x, u0, u1, t8, triplets, tables, p4=None, pairs=None) -> None:
    """Raise unless the kernel takes these arguments: x (S,N) int64, u0 /
    u1 (N,) float32, t8 (T,8) float32 with triplets (T,3) and the (N,MT)
    triplet incidence, p4 (P,4) float32 with pairs (P,2) and the (N,MP)
    pair incidence (int64 ids), the flat colour table (int32), all
    contiguous on x's device. Reads no device value."""
    dev, need = x.device, SEAM.need
    need("x", x, torch.int64, dev, 2)
    N = x.shape[1]
    for name, u in (("u0", u0), ("u1", u1)):
        need(name, u, torch.float32, dev, 1)
        if u.shape[0] != N:
            raise ValueError(f"icm_binary: {name} has {u.shape[0]} nodes, "
                             f"x {N}")
    for name, table, rows, inc, own, width in (
            ("t8", t8, triplets, "vert_tri", "vert_tri_corner", 3),
            ("p4", p4, pairs, "vert_pair", "vert_pair_end", 2)):
        if table is None:
            continue
        need(name, table, torch.float32, dev, 2, 2 ** width)
        need(name[:1] + " rows", rows, torch.int64, dev, 2, width)
        if rows.shape[0] != table.shape[0]:
            raise ValueError(f"icm_binary: {name} has {table.shape[0]} rows, "
                             f"its members {rows.shape[0]}")
        a, b = getattr(tables, inc), getattr(tables, own)
        for tname, t in ((inc, a), (own, b)):
            if t is None:
                raise ValueError(f"icm_binary: {name} given without {tname}")
            need(tname, t, torch.int64, dev, 2)
        if a.shape[0] != N or a.shape != b.shape:
            raise ValueError(f"icm_binary: {inc} / {own} must be ({N}, M), "
                             f"got {tuple(a.shape)} / {tuple(b.shape)}")
    ids, offsets = tables.color_ids, tables.color_offsets
    need("color_ids", ids, torch.int32, dev, 1)
    need("color_offsets", offsets, torch.int32, dev, 1)
    if offsets.shape[0] != len(tables.groups) + 1:
        raise ValueError("icm_binary: color_offsets must hold one more entry "
                         "than there are colour groups")


def launch(x, es, u0, u1, t8, triplets, tables, icm_passes: int, p4=None,
           pairs=None) -> None:
    """One unchecked launch of the kernel on x's device: x (S,N) is
    overwritten with the descents' results and es (S,) with their
    energies. Does not count (`icm_binary` does)."""
    none = (None, None)
    tri = none if t8 is None else (tables.vert_tri, tables.vert_tri_corner)
    pair = none if p4 is None else (tables.vert_pair, tables.vert_pair_end)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def width(t):
        return 0 if t is None else t.shape[1]

    SEAM.call("icm_binary_launch", x.device,
              x.data_ptr(), es.data_ptr(), x.shape[0], x.shape[1],
              u0.data_ptr(), u1.data_ptr(), ptr(t8), ptr(triplets),
              ptr(tri[0]), ptr(tri[1]), width(tri[0]),
              0 if t8 is None else t8.shape[0], ptr(p4), ptr(pairs),
              ptr(pair[0]), ptr(pair[1]), width(pair[0]),
              0 if p4 is None else p4.shape[0],
              tables.color_ids.data_ptr(), tables.color_offsets.data_ptr(),
              len(tables.groups), int(icm_passes))


def _kernel(x, u0, u1, t8, triplets, tables, icm_passes: int, p4=None,
            pairs=None):
    check(x, u0, u1, t8, triplets, tables, p4, pairs)
    es = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    launch(x, es, u0, u1, t8, triplets, tables, icm_passes, p4, pairs)
    return x, es


def icm_binary(x, u0, u1, t8, triplets, tables, icm_passes: int, p4=None,
               pairs=None):
    """The multi-start binary ICM of a fusion move from the starts x (S,N),
    overwritten with the results: (x, es (S,) energies). The kernel needs
    the flat colour table of `tables`. No host sync on the card."""
    return SEAM.run(x, icm_binary_twin, _kernel, x, u0, u1, t8, triplets,
                    tables, icm_passes, p4, pairs)
