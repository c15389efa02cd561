"""Label-map problems at the gMSM levels' shapes, the comparison of K4
(csrc/label_forward.cu) with its plain version, and their times on the card
beside the bound of the call's work. chip_smoke.py and
tests/test_torch_cuda.py build their problems here.

A problem is the argument tuple of ops.labelmap.label_forward: (grids,
faces, ring_faces, ring_verts, tmpl_coords). The data grid is the
ico-`res` sphere under a smooth random warp (eval/synth.py), displaced by
the sampling-grid labels of the gMSM tutorial's level at that data grid
(LEVELS); the template is the ico-6 sphere of the gMSM cells.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import RAD
from ..core.icosphere import icosphere
from ..core.mesh import Mesh
from ..eval.synth import smooth_sphere_warp
from ..reg.sampling_grid import build_sampling_grid
from . import labelmap
from .locate_bench import PEAK_FP32_FLOPS, time_launches
from .nearest import build_tables

# the gMSM tutorial's levels (gmsm_tutorial_ico6): data grid -> (control
# grid, sampling grid); 19, 19 and 18 labels
LEVELS = {4: (2, 4), 5: (3, 5), 6: (4, 6)}
TEMPLATE_RES = 6
# operations counted for the bound: an exact squared distance is 3
# differences, 3 products and 2 sums (the compare is not counted)
FLOPS_A_DISTANCE = 8
# K4 against the plain version: the rows (a label's template vertex) whose
# triangle differs, at most MAX_DIFFERING_SHARE of them and each a near
# tie: in float64 both triangles hold the point (barycentric coordinates
# >= -TIE_BARY, twice the containment tolerance) and its boundary
# distances in them differ by at most TIE_MM; the weights of the other
# rows within W_ATOL
MAX_DIFFERING_SHARE = 1e-4
TIE_BARY = 2e-4
TIE_MM = 1e-4
W_ATOL = 1e-6


def problem(res: int = 6, device="cuda", seed: int = 3,
            degrees: float = 4.0) -> tuple:
    """label_forward's arguments at the data grid ico-`res` of a gMSM
    level, on `device`."""
    dg = Mesh.from_icosphere(res)
    warped = smooth_sphere_warp(dg.coords / RAD, seed, degrees) * RAD
    cp, sg = LEVELS[res]
    grid = build_sampling_grid(sg, 0.5 * Mesh.from_icosphere(cp)
                               .calculate_MaxVD())
    tabs = build_tables(warped, dg.faces, dg.adjacency[2], device)

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(device)

    return (labelmap.deformed_grids(f32(warped), f32(grid.samples),
                                    f32(grid.centre)),
            tabs.faces, tabs.ring_faces, tabs.ring_verts,
            f32(icosphere(TEMPLATE_RES).coords * RAD))


def _held(grid: np.ndarray, q: np.ndarray, tri: np.ndarray):
    """(least barycentric coordinate, boundary distance) of q projected
    onto the plane of triangle `tri` (corner ids) of grid, in float64."""
    a, b, c = grid[tri]
    n = np.cross(b - a, c - a)
    p = q * (n @ a) / (n @ q)
    nn = n @ n
    bary = [np.cross(y - x, p - x) @ n / nn
            for x, y in ((b, c), (c, a), (a, b))]

    def seg(x, y):
        t = np.clip((p - x) @ (y - x) / ((y - x) @ (y - x)), 0.0, 1.0)
        return np.linalg.norm(p - (x + t * (y - x)))

    return min(bary), min(seg(a, b), seg(a, c), seg(b, c))


def compare(p, stride: int = 7) -> dict:
    """K4 on the card against the plain version on the CPU, from the same
    grids (p on the CPU): every label, and the kernel's rows of every
    `stride`-th template vertex (the plain version takes some 6 s a label
    at ico-6 on the CPU)."""
    grids, faces, ring_faces, ring_verts, tmpl = p
    cuda = torch.device("cuda")
    tv_k, w_k = labelmap.label_forward(*(t.to(cuda) for t in p))
    torch.cuda.synchronize()
    tv_k, w_k = tv_k[:, ::stride].cpu(), w_k[:, ::stride].cpu()
    tv_p, w_p = labelmap.label_forward_twin(
        grids, faces, ring_faces, ring_verts, tmpl[::stride].contiguous())
    differ = (tv_k != tv_p).any(-1)
    w_gap = float((w_k - w_p)[~differ].abs().max())
    ties = []
    for l, q in differ.nonzero().tolist():
        g = grids[l].double().numpy()
        x = tmpl[q * stride].double().numpy()
        (bk, dk), (bp, dp) = (_held(g, x, t[l, q].numpy())
                              for t in (tv_k, tv_p))
        ties.append(min(bk, bp) >= -TIE_BARY and abs(dk - dp) <= TIE_MM)
    share = float(differ.float().mean())
    return {"ok": (share <= MAX_DIFFERING_SHARE and w_gap <= W_ATOL
                   and all(ties)),
            "rows": int(differ.numel()), "differing": int(differ.sum()),
            "share": share, "near_ties": int(sum(ties)),
            "w_gap": w_gap, "w_bits_equal": bool(torch.equal(
                w_k[~differ], w_p[~differ])),
            "labels": int(grids.shape[0])}


def bound(p) -> dict:
    """The least time of a call's work on the card: L x Nt x N exact
    distances at FLOPS_A_DISTANCE flops, at the float32 peak (the bytes, a
    few MB, take microseconds)."""
    grids, _, _, _, tmpl = p
    distances = grids.shape[0] * tmpl.shape[0] * grids.shape[1]
    flops = distances * FLOPS_A_DISTANCE
    return {"distances": int(distances), "flops": int(flops),
            "bound_ms": 1e3 * flops / PEAK_FP32_FLOPS}


def time_forward(p, launches: int = 20) -> dict:
    """Milliseconds a call of K4 on the card's clock (windows between CUDA
    events) and of the plain version on the card, beside the bound."""
    k = time_launches(lambda: labelmap.label_forward(*p), windows=3,
                      launches=launches, warmup=3)
    plain = time_launches(lambda: labelmap.label_forward_twin(*p),
                          windows=1, launches=1, warmup=1)
    b = bound(p)
    return {"kernel_ms": k["ms"], "kernel_ms_spread": k["ms_spread"],
            "plain_ms": plain["ms"], "share": b["bound_ms"] / k["ms"],
            "labels": int(p[0].shape[0]), "grid": int(p[0].shape[1]),
            "template": int(p[4].shape[0]),
            "clock_samples_mhz_w": k["clock_samples_mhz_w"], **b}
