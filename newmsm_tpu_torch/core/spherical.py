"""Batched spherical / triangle math on torch tensors.

Port of newmsm_tpu/core/spherical.py (the reference point/triangle algebra,
point.cpp, triangle.cpp, reg_tools.cpp tangent-basis code). Every function
broadcasts over leading batch dimensions.
"""
from __future__ import annotations

import torch

from .. import EPSILON


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def normalize(v, eps=EPSILON):
    """Safe normalisation: v unchanged when ||v|| <= eps
    (Point::normalize, point.cpp:26-34)."""
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    ok = n > eps
    return torch.where(ok, v / torch.where(ok, n, torch.ones_like(n)), v)


def rodrigues(frm, to, eps=EPSILON):
    """Rotation matrix taking the direction of `frm` to that of `to`
    (estimate_rotation_matrix, point.cpp:97-152, with its special cases).
    frm/to: (...,3) -> (...,3,3)."""
    a = normalize(frm, eps)
    b = normalize(to, eps)
    dot = (a * b).sum(-1)
    cross = _cross(a, b)
    cross_n = torch.linalg.norm(cross, dim=-1)
    axis = normalize(cross, eps)

    eye = torch.eye(3, dtype=a.dtype, device=a.device).expand(
        a.shape[:-1] + (3, 3))
    zero = torch.zeros_like(axis[..., 0])
    u = torch.stack([
        torch.stack([zero, -axis[..., 2], axis[..., 1]], dim=-1),
        torch.stack([axis[..., 2], zero, -axis[..., 0]], dim=-1),
        torch.stack([-axis[..., 1], axis[..., 0], zero], dim=-1),
    ], dim=-2)
    theta = torch.arccos(dot.clamp(-1.0, 1.0))
    s = torch.sin(theta)[..., None, None]
    c = (1.0 - torch.cos(theta))[..., None, None]
    r_general = eye + u * s + c * (u @ u)

    outer = axis[..., :, None] * axis[..., None, :]
    r_antipodal = 2.0 * outer - eye

    # branch thresholds sized for float32 (see the JAX original)
    beps = 1e-6
    degenerate_axis = cross_n < beps
    aligned = degenerate_axis & (dot > 0)
    anti_degenerate = degenerate_axis & (dot <= 0)
    near_neg = (~degenerate_axis) & (dot < -1.0 + beps)

    r = torch.where(near_neg[..., None, None], r_antipodal, r_general)
    r = torch.where(anti_degenerate[..., None, None], -eye, r)
    return torch.where(aligned[..., None, None], eye, r)


def euler_matrix(w1, w2, w3):
    """Euler rotation matrix of euler_rotate (point.cpp:154-171); w* are
    0-d tensors. ``points @ M`` reproduces the reference's R.t() * v."""
    c1, s1 = torch.cos(w1), torch.sin(w1)
    c2, s2 = torch.cos(w2), torch.sin(w2)
    c3, s3 = torch.cos(w3), torch.sin(w3)
    return torch.stack([
        torch.stack([c2 * c3, -c1 * s3 + s1 * s2 * c3, s1 * s3 + c1 * s2 * c3]),
        torch.stack([c2 * s3, c1 * c3 + s1 * s2 * s3, -s1 * c3 + c1 * s2 * s3]),
        torch.stack([-s2, s1 * c2, c1 * c2]),
    ])


def apply_euler(points, w1, w2, w3):
    """Rotate (...,3) points by R(w1,w2,w3).T (point.cpp:167)."""
    return points @ euler_matrix(w1, w2, w3).to(points.dtype)


def project_to_plane(p, v0, v1, v2, eps=EPSILON):
    """Scale p along its ray to the plane of triangle (v0,v1,v2)
    (project_point, point.cpp:46-60)."""
    s1 = normalize(v2 - v0, eps)
    s2 = normalize(v1 - v0, eps)
    n = normalize(_cross(s1, s2), eps)
    denom = (n * p).sum(-1)
    si = (n * v0).sum(-1) / torch.where(denom.abs() > 0, denom,
                                        torch.ones_like(denom))
    return p * si[..., None]


def tri_area(v0, v1, v2):
    """Triangle area (point.cpp:68-75)."""
    return 0.5 * torch.linalg.norm(_cross(v1 - v0, v2 - v0), dim=-1)


def tri_normal(v0, v1, v2, eps=EPSILON):
    """Reference triangle normal normalize((v2-v0) x (v1-v0))
    (triangle.cpp:42-47)."""
    return normalize(_cross(v2 - v0, v1 - v0), eps)


def point_in_triangle_relative(p, a, b, c, rel_tol=1e-4):
    """Scale-aware containment test: signed sub-areas against the face
    normal, thresholded relative to the squared face area."""
    n = _cross(b - a, c - a)
    nn = (n * n).sum(-1)
    s1 = (_cross(c - b, p - b) * n).sum(-1)
    s2 = (_cross(a - c, p - c) * n).sum(-1)
    s3 = (_cross(b - a, p - a) * n).sum(-1)
    tol = -rel_tol * nn
    return (s1 >= tol) & (s2 >= tol) & (s3 >= tol)


def dist_to_triangle_boundary(x0, x1, x2, x3):
    """Triangle::dist_to_point (triangle.cpp:85-122): min distance from x0
    to the triangle's edges (foot inside the segment) and vertices."""
    big = torch.finfo(x0.dtype).max

    def edge_dist(a, b):
        u = b - a
        t_ok = (((x0 - a) * u).sum(-1) > 0) & (((x0 - b) * u).sum(-1) < 0)
        d = torch.linalg.norm(_cross(x0 - a, x0 - b), dim=-1) / torch.clamp(
            torch.linalg.norm(u, dim=-1), min=1e-30)
        return torch.where(t_ok, d, torch.full_like(d, big))

    d = torch.minimum(edge_dist(x1, x2),
                      torch.minimum(edge_dist(x1, x3), edge_dist(x2, x3)))
    for v in (x1, x2, x3):
        d = torch.minimum(d, torch.linalg.norm(x0 - v, dim=-1))
    return d


def barycentric_weights(v1, v2, v3, p):
    """Barycentric weights of p (projected onto the triangle plane) wrt
    (v1,v2,v3), calc_barycentric_weights (triangle.cpp:124-143). (...,3)."""
    pp = project_to_plane(p, v1, v2, v3)
    aa = tri_area(pp, v2, v3)
    ab = tri_area(pp, v1, v3)
    ac = tri_area(pp, v1, v2)
    total = aa + ab + ac
    total = torch.where(total > 0, total, torch.ones_like(total))
    return torch.stack([aa, ab, ac], dim=-1) / total[..., None]


def tangent_basis_from_normal(a, eps=1e-30):
    """Orthonormal tangent pair (e1,e2) to direction `a`, calculate_tri
    (reg_tools.cpp:267-313)."""
    xhat = torch.zeros_like(a)
    xhat[..., 0] = 1.0
    yhat = torch.zeros_like(a)
    yhat[..., 1] = 1.0
    c = _cross(a, xhat)
    use_y = (c * c).sum(-1, keepdim=True) <= eps
    c = torch.where(use_y, _cross(a, yhat), c)
    e1 = normalize(c)
    e2 = normalize(_cross(a, e1))
    return e1, e2


def vertex_tangent_basis(a):
    """calculate_tangs (reg_tools.cpp:205-265): tangent basis from an
    outward vertex normal `a`."""
    ax, ay, az = a[..., 0].abs(), a[..., 1].abs(), a[..., 2].abs()
    zero = torch.zeros_like(ax)
    one = torch.ones_like(ax)

    def e1_for(mag, num_a, num_b, layout, fallback):
        safe = torch.where(mag > 0, mag, one)
        comps = {"0": zero, "a": num_a / safe, "b": num_b / safe}
        e = torch.stack([comps[k] for k in layout], dim=-1)
        return torch.where((mag == 0)[..., None],
                           torch.stack(fallback, dim=-1), e)

    mag_x = torch.sqrt(a[..., 2] ** 2 + a[..., 1] ** 2)
    e1_x = e1_for(mag_x, -a[..., 2], a[..., 1], "0ab", (zero, zero, one))
    mag_y = torch.sqrt(a[..., 2] ** 2 + a[..., 0] ** 2)
    e1_y = e1_for(mag_y, -a[..., 2], a[..., 0], "a0b", (zero, zero, one))
    mag_z = torch.sqrt(a[..., 1] ** 2 + a[..., 0] ** 2)
    e1_z = e1_for(mag_z, -a[..., 1], a[..., 0], "ab0", (one, zero, zero))

    x_dom = (ax >= ay) & (ax >= az)
    y_dom = (~x_dom) & (ay >= ax) & (ay >= az)
    e1 = torch.where(x_dom[..., None], e1_x,
                     torch.where(y_dom[..., None], e1_y, e1_z))
    e2 = normalize(_cross(a, e1))
    return e1, e2
