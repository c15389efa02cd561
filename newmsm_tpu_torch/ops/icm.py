"""Binary ICM of one fusion move on the card: the wrapper of the
hand-written CUDA kernel csrc/icm_binary.cu (K2), which replaces no TPU
kernel (the JAX package runs the loop inside one XLA program).

`icm_binary` runs every start's descent and energy in one launch, the
work of the plain version reg/optimise/fusion.py::_binary_icm +
binary_energy (the twin), which `fusion.binary_icm` runs for CPU tensors.
Anything the kernel does not take raises here: there is no fallback from
the kernel to the twin. The comparison of the two runs in
tests/test_torch_cuda.py and in chip_smoke.py.
"""
from __future__ import annotations

import ctypes

import torch

from .. import trace

SOURCE = "icm_binary.cu"
KERNEL = "icm_binary_kernel"      # name of the __global__ template
LAUNCHES = 0        # kernel launches since the last reset (plain int)


@trace.cached()
def library() -> ctypes.CDLL:
    """The built ICM library, its launch function declared."""
    from ._build import load
    lib = load(SOURCE, mark="k2.load")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.icm_binary_launch.argtypes = [p, p, i, i, p, p, p, p, p, p, i, ll, p,
                                      p, p, p, i, ll, p, p, i, i, p]
    lib.icm_binary_launch.restype = ctypes.c_int
    return lib


def _need(name, t, dtype, dev, ndim=None, cols=None):
    if t.device != dev:
        raise ValueError(f"icm_binary: {name} is on {t.device}, the starts "
                         f"on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"icm_binary: {name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"icm_binary: {name} must have {ndim} dimensions, "
                         f"got shape {tuple(t.shape)}")
    if cols is not None and t.shape[1] != cols:
        raise ValueError(f"icm_binary: {name} must have {cols} columns, got "
                         f"shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"icm_binary: {name} must be contiguous")


def check(x, u0, u1, t8, triplets, tables, p4=None, pairs=None) -> None:
    """Raise unless the kernel takes these arguments: x (S,N) int64, u0 /
    u1 (N,) float32, t8 (T,8) float32 with triplets (T,3) and the (N,MT)
    triplet incidence, p4 (P,4) float32 with pairs (P,2) and the (N,MP)
    pair incidence (int64 ids), the flat colour table (int32), all
    contiguous on x's device. Reads no device value."""
    dev = x.device
    _need("x", x, torch.int64, dev, 2)
    N = x.shape[1]
    for name, u in (("u0", u0), ("u1", u1)):
        _need(name, u, torch.float32, dev, 1)
        if u.shape[0] != N:
            raise ValueError(f"icm_binary: {name} has {u.shape[0]} nodes, "
                             f"x {N}")
    for name, table, rows, inc, own, width in (
            ("t8", t8, triplets, "vert_tri", "vert_tri_corner", 3),
            ("p4", p4, pairs, "vert_pair", "vert_pair_end", 2)):
        if table is None:
            continue
        _need(name, table, torch.float32, dev, 2, 2 ** width)
        _need(name[:1] + " rows", rows, torch.int64, dev, 2, width)
        if rows.shape[0] != table.shape[0]:
            raise ValueError(f"icm_binary: {name} has {table.shape[0]} rows, "
                             f"its members {rows.shape[0]}")
        a, b = getattr(tables, inc), getattr(tables, own)
        for tname, t in ((inc, a), (own, b)):
            if t is None:
                raise ValueError(f"icm_binary: {name} given without {tname}")
            _need(tname, t, torch.int64, dev, 2)
        if a.shape[0] != N or a.shape != b.shape:
            raise ValueError(f"icm_binary: {inc} / {own} must be ({N}, M), "
                             f"got {tuple(a.shape)} / {tuple(b.shape)}")
    ids, offsets = tables.color_ids, tables.color_offsets
    _need("color_ids", ids, torch.int32, dev, 1)
    _need("color_offsets", offsets, torch.int32, dev, 1)
    if offsets.shape[0] != len(tables.groups) + 1:
        raise ValueError("icm_binary: color_offsets must hold one more entry "
                         "than there are colour groups")


def launch(x, es, u0, u1, t8, triplets, tables, icm_passes: int, p4=None,
           pairs=None) -> None:
    """One unchecked launch of the kernel on x's device and PyTorch's
    current stream: x (S,N) is overwritten with the descents' results and
    es (S,) with their energies; raises on a CUDA error. Does not count
    (`icm_binary` does)."""
    dev = x.device
    none = (None, None)
    tri = none if t8 is None else (tables.vert_tri, tables.vert_tri_corner)
    pair = none if p4 is None else (tables.vert_pair, tables.vert_pair_end)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def width(t):
        return 0 if t is None else t.shape[1]

    with torch.cuda.device(dev):
        rc = library().icm_binary_launch(
            x.data_ptr(), es.data_ptr(), x.shape[0], x.shape[1],
            u0.data_ptr(), u1.data_ptr(), ptr(t8), ptr(triplets),
            ptr(tri[0]), ptr(tri[1]), width(tri[0]),
            0 if t8 is None else t8.shape[0], ptr(p4), ptr(pairs),
            ptr(pair[0]), ptr(pair[1]), width(pair[0]),
            0 if p4 is None else p4.shape[0],
            tables.color_ids.data_ptr(), tables.color_offsets.data_ptr(),
            len(tables.groups), int(icm_passes),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"icm_binary kernel launch failed: CUDA error "
                           f"{rc}")


def icm_binary(x, u0, u1, t8, triplets, tables, icm_passes: int, p4=None,
               pairs=None):
    """The multi-start binary ICM of fusion.binary_icm on the card: x (S,N)
    starts, overwritten with the results; returns (x, es (S,) energies).
    No host sync."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"icm_binary: unsupported device {x.device}")
    check(x, u0, u1, t8, triplets, tables, p4, pairs)
    es = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    launch(x, es, u0, u1, t8, triplets, tables, icm_passes, p4, pairs)
    LAUNCHES += 1
    return x, es
