"""Forward maps of the group driver's label-deformed data grids: the
wrapper of the hand-written CUDA kernel csrc/label_forward.cu (K4), which
replaces no TPU kernel (the JAX package searches each label's grid as XLA
ops), and its plain PyTorch version, the twin `label_forward_twin`.
`label_forward`, every label's triangle and barycentric weights of every
template vertex in one call, picks one by device (ops/_build.py,
`Kernel.run`).
"""
from __future__ import annotations

import torch

from .. import RAD, trace
from ..core import spherical as sph
from . import _build
from .nearest import SearchTables, barycentric_coords

SOURCE = "label_forward.cu"
KERNEL = "label_forward_kernel"
MAX_LABELS = 65535                # the grid's second dimension
P, I = _build.PTR, _build.INT
SEAM = _build.Kernel("labelmap", SOURCE, "label_forward", "k4.load", {
    "label_forward_launch": ([P, I, I, P, I, P, I, _build.FLOAT, P, P, P],
                             I)})


def deformed_grids(dg_coords, labels, centre):
    """(L,N,3): vertex x of the data grid displaced by label l to
    R(centre->x) @ label_l (get_patch_data, DiscreteGroupModel.cpp:88-121),
    every label at once; a label's rows do not depend on the others."""
    rots = sph.rodrigues(centre.expand(dg_coords.shape), dg_coords)  # (N,3,3)
    return (rots[None] * labels[:, None, None, :]).sum(-1)


def label_forward_twin(grids, faces, ring_faces, ring_verts, tmpl_coords):
    """The plain version, a label at a time: barycentric_coords of the
    template points on each label's grid (ops/nearest.py, the dense search
    and the 2-ring containment choice). Returns (tv (L,Nt,3) int64,
    w (L,Nt,3))."""
    maps = [barycentric_coords(tmpl_coords, SearchTables(
        coords=g, faces=faces, ring_faces=ring_faces, ring_verts=ring_verts))
        for g in grids]
    return (torch.stack([tv for tv, _ in maps]),
            torch.stack([w for _, w in maps]))


def check(grids, ring_verts, tmpl_coords) -> None:
    """Raise unless the kernel takes these arguments: grids (L,N,3) and
    tmpl_coords (Nt,3) float32, ring_verts (N,C,3) int64, contiguous, on
    grids' device, with 1 <= L <= MAX_LABELS, N, Nt, C >= 1 and N, Nt <
    2^31. Reads no device value."""
    SEAM.need("grids", grids, torch.float32, grids.device, 3)
    SEAM.need("tmpl_coords", tmpl_coords, torch.float32, grids.device, 2, 3)
    SEAM.need("ring_verts", ring_verts, torch.int64, grids.device, 3)
    L, N, three = grids.shape
    if three != 3 or ring_verts.shape[2] != 3:
        raise ValueError(f"label_forward: grids {tuple(grids.shape)} and "
                         f"ring_verts {tuple(ring_verts.shape)} must end in 3")
    if not 1 <= L <= MAX_LABELS:
        raise ValueError(f"label_forward: {L} labels, not 1 to {MAX_LABELS}")
    if ring_verts.shape[0] != N or ring_verts.shape[1] < 1:
        raise ValueError(f"label_forward: ring_verts {tuple(ring_verts.shape)}"
                         f" does not fit a grid of {N} vertices")
    if not 1 <= N < 2 ** 31 or not 1 <= tmpl_coords.shape[0] < 2 ** 31:
        raise ValueError(f"label_forward: {N} grid and {tmpl_coords.shape[0]}"
                         f" template vertices, not 1 to 2^31 - 1")


def _kernel(grids, faces, ring_faces, ring_verts, tmpl_coords):
    check(grids, ring_verts, tmpl_coords)
    L, N, _ = grids.shape
    nt = tmpl_coords.shape[0]
    tv = torch.empty((L, nt, 3), dtype=torch.int64, device=grids.device)
    w = torch.empty((L, nt, 3), dtype=torch.float32, device=grids.device)
    SEAM.call("label_forward_launch", grids.device, grids.data_ptr(), L, N,
              tmpl_coords.data_ptr(), nt, ring_verts.data_ptr(),
              ring_verts.shape[1], RAD, tv.data_ptr(), w.data_ptr())
    return tv, w


def label_forward(grids, faces, ring_faces, ring_verts, tmpl_coords):
    """(tv (L,Nt,3) int64, w (L,Nt,3)): for every label's grid (L,N,3) and
    every template point, the corners of the triangle the reference octree
    chooses and the point's barycentric weights in it, as
    barycentric_coords gives them a label at a time. Counts the labels and
    queries of the call (`labelmap.labels`, `labelmap.queries`)."""
    trace.count("labelmap.labels", grids.shape[0])
    trace.count("labelmap.queries", grids.shape[0] * tmpl_coords.shape[0])
    return SEAM.run(grids, label_forward_twin, _kernel, grids, faces,
                    ring_faces, ring_verts, tmpl_coords)
