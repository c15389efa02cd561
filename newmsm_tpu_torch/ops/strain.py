"""Hyper-elastic strain energies, batched closed form.

Port of newmsm_tpu/ops/strain.py (triangle_strain /
calculate_triangular_strain, reg_tools.cpp:551-743): project both triangles
to their tangent planes, form the 2x2 deformation gradient F from edge
vectors, take I1 = tr(F^T F)+1 and I3 = det, and evaluate

    W = mu/2 (R^k + R^-k - 2) + kappa/2 (J^k + J^-k - 2)

with J = sqrt(I3) and R the major/minor stretch ratio from (I1-1)/J.
"""
from __future__ import annotations

import torch

from ..core import spherical as sph


def _tangent_frame(normal):
    """calculate_tri from a normal (reg_tools.cpp:267-313) -> (e1, e2)."""
    return sph.tangent_basis_from_normal(normal)


def _project_2d(verts, e1, e2, det_ref):
    """Tangent-plane coordinates of triangle vertices (...,3,3); the two
    columns swap when det([e1 e2 n]) of the ORIGINAL frame is negative
    (reg_tools.cpp:712-727, both swaps test the first frame's det)."""
    x = (verts * e1[..., None, :]).sum(-1)
    y = (verts * e2[..., None, :]).sum(-1)
    swap = (det_ref < 0)[..., None]
    return torch.where(swap, y, x), torch.where(swap, x, y)


def _frame_det(e1, e2, n):
    return (torch.linalg.cross(e1, e2, dim=-1) * n).sum(-1)


def triangle_strain_2d(ax, ay, bx, by, mu, kappa, k_exp):
    """Strain energy from 2-D projected coordinates; a*/b* are (...,3)
    original/final x and y vertex coordinates (reg_tools.cpp:551-597)."""
    c0 = ax[..., 1] - ax[..., 0]
    c1 = ay[..., 1] - ay[..., 0]
    c4 = ax[..., 2] - ax[..., 0]
    c5 = ay[..., 2] - ay[..., 0]
    c0c = bx[..., 1] - bx[..., 0]
    c1c = by[..., 1] - by[..., 0]
    c4c = bx[..., 2] - bx[..., 0]
    c5c = by[..., 2] - by[..., 0]

    # F = edges_final @ inv(edges_orig), 2x2 closed form
    det = c0 * c5 - c4 * c1
    det = torch.where(det.abs() > 0, det, torch.full_like(det, 1e-30))
    f11 = (c0c * c5 - c4c * c1) / det
    f12 = (-c0c * c4 + c4c * c0) / det
    f21 = (c1c * c5 - c5c * c1) / det
    f22 = (-c1c * c4 + c5c * c0) / det

    i1 = f11 * f11 + f21 * f21 + f12 * f12 + f22 * f22 + 1.0
    i3 = (f11 * f22 - f12 * f21) ** 2
    j = torch.sqrt(torch.clamp(i3, min=1e-30))
    i1st = (i1 - 1.0) / j
    r = torch.where(i1st <= 2.0, torch.ones_like(i1st),
                    0.5 * (i1st + torch.sqrt(torch.clamp(i1st * i1st - 4.0,
                                                         min=0.0))))
    rk = torch.pow(r, k_exp)
    jk = torch.pow(j, k_exp)
    return 0.5 * (mu * (rk + 1.0 / rk - 2.0) + kappa * (jk + 1.0 / jk - 2.0))


def triangular_strain(orig_verts, final_verts, mu, kappa, k_exp):
    """calculate_triangular_strain on vertex coordinate triples
    (reg_tools.cpp:698-743). orig/final: (...,3,3) with axis -2 the vertex.
    Returns (...,) strain energies."""
    n_o = sph.tri_normal(orig_verts[..., 0, :], orig_verts[..., 1, :],
                         orig_verts[..., 2, :])
    n_f = sph.tri_normal(final_verts[..., 0, :], final_verts[..., 1, :],
                         final_verts[..., 2, :])
    e1o, e2o = _tangent_frame(n_o)
    e1f, e2f = _tangent_frame(n_f)
    det_o = _frame_det(e1o, e2o, n_o)
    ax, ay = _project_2d(orig_verts, e1o, e2o, det_o)
    bx, by = _project_2d(final_verts, e1f, e2f, det_o)
    return triangle_strain_2d(ax, ay, bx, by, mu, kappa, k_exp)


def principal_strains_2d(ax, ay, bx, by):
    """Principal (Green-Lagrange) strains of the 2-D deformation, closed form
    (reg_tools.cpp:598-643). Returns (emax, emin)."""
    c0 = ax[..., 1] - ax[..., 0]
    c1 = ay[..., 1] - ay[..., 0]
    c2 = ax[..., 2] - ax[..., 1]
    c3 = ay[..., 2] - ay[..., 1]
    c4 = ax[..., 2] - ax[..., 0]
    c5 = ay[..., 2] - ay[..., 0]
    c0c = bx[..., 1] - bx[..., 0]
    c1c = by[..., 1] - by[..., 0]
    c2c = bx[..., 2] - bx[..., 1]
    c3c = by[..., 2] - by[..., 1]
    c4c = bx[..., 2] - bx[..., 0]
    c5c = by[..., 2] - by[..., 0]

    a = torch.stack([
        torch.stack([2 * c0 * c0, 2 * c1 * c1, 4 * c0 * c1], -1),
        torch.stack([2 * c2 * c2, 2 * c3 * c3, 4 * c2 * c3], -1),
        torch.stack([2 * c4 * c4, 2 * c5 * c5, 4 * c4 * c5], -1),
    ], -2)
    bvec = torch.stack([
        c0c**2 + c1c**2 - c0**2 - c1**2,
        c2c**2 + c3c**2 - c2**2 - c3**2,
        c4c**2 + c5c**2 - c4**2 - c5**2,
    ], -1)
    e = torch.linalg.solve(a, bvec[..., None])[..., 0]
    e11, e22, e12 = e[..., 0], e[..., 1], e[..., 2]
    x = e11 + e22
    y = e11 - e22
    root = torch.sqrt((y / 2) ** 2 + e12**2)
    return x / 2 + root, x / 2 - root
