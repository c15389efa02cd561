"""Rigid (rotational) pre-alignment (Rigid_cost_function,
rigid_costfunction.cpp). Port of newmsm_tpu/reg/rigid.py.

The cost is a tangent-plane Gaussian-weighted similarity between each
rotated source vertex and its angular neighbourhood on the target. On the
card one call of the hand-written kernel K3 (ops/rigid.py,
csrc/rigid_cost.cu) computes it; on the CPU its plain version (the twin)
does, one masked dense product per chunk of source vertices. The annealed
finite-difference ascent over 3 Euler angles is the reference's loop, with
the JAX package's lax.while_loop written as a Python loop (one host sync
per iteration, to read the `done` flag). Under tracing each gradient step
is an `affine.step` mark, and each cost evaluation a `cost_evals` count and
a `rigid.kernel` (K3) or `rigid.twin` count.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import RAD, resolve_device, trace
from ..core import spherical as sph
from ..core.mesh import Mesh
from ..ops import rigid as _rigid


def rigid_cost(angles, src_coords, src_data_c, tgt_coords, tgt_data_c,
               cos_ang: float, min_sigma: float, simval: int):
    """Total similarity of the rotated source against the target (0-d).
    angles (3,); src_data_c/tgt_data_c: (D,N) mean-removed feature columns;
    cos_ang: neighbourhood gate cos(2*asin(4*MVD/(2*RAD))). CPU tensors run
    the twin (`rigid_cost_twin`); any other device rotates the source and
    launches K3 (`ops.rigid.rigid_terms`), which raises on what it does not
    take."""
    if src_coords.device.type == "cpu":
        trace.count("rigid.twin")
        return rigid_cost_twin(angles, src_coords, src_data_c, tgt_coords,
                               tgt_data_c, cos_ang, min_sigma, simval)
    rot = sph.apply_euler(src_coords, angles[0], angles[1], angles[2])
    total, _ = _rigid.rigid_terms(rot, src_data_c, tgt_coords, tgt_data_c,
                                  cos_ang, min_sigma, simval)
    trace.count("rigid.kernel")
    return total


def rigid_cost_twin(angles, src_coords, src_data_c, tgt_coords, tgt_data_c,
                    cos_ang: float, min_sigma: float, simval: int,
                    chunk: int = 2048):
    """`rigid_cost` in plain PyTorch ops, on any device: the rotation, then
    the sum of `rigid_terms_twin`'s chunks in chunk order."""
    rot = sph.apply_euler(src_coords, angles[0], angles[1], angles[2])
    total = torch.zeros((), dtype=src_coords.dtype, device=src_coords.device)
    for jp in rigid_terms_twin(rot, src_data_c, tgt_coords, tgt_data_c,
                               cos_ang, min_sigma, simval, chunk):
        total = total + jp.sum()
    return total


def rigid_terms_twin(rot, src_data_c, tgt_coords, tgt_data_c,
                     cos_ang: float, min_sigma: float, simval: int,
                     chunk: int = 2048):
    """The plain version of K3: each rotated source's weighted neighbourhood
    similarity jp, yielded a chunk of `chunk` sources at a time."""
    tgt_unit = tgt_coords / torch.linalg.norm(tgt_coords, dim=1, keepdim=True)
    src_norm = torch.linalg.norm(src_data_c, dim=0)
    tgt_norm = torch.linalg.norm(tgt_data_c, dim=0)

    for s in range(0, rot.shape[0], chunk):
        rc = rot[s:s + chunk]
        sn = src_norm[s:s + chunk]
        sd = src_data_c[:, s:s + chunk]
        unit = rc / torch.linalg.norm(rc, dim=1, keepdim=True)
        nbh = (unit @ tgt_unit.T) >= cos_ang                    # (c,Nt)

        # tangent-plane offsets of the targets around the radial point (the
        # source's own offset is zero) (WLS_simgradient,
        # rigid_costfunction.cpp:60-85)
        e1, e2 = sph.vertex_tangent_basis(unit)
        diff = tgt_coords[None, :, :] - rc[:, None, :]
        d1 = torch.einsum("cnk,ck->cn", diff, e1)
        d2 = torch.einsum("cnk,ck->cn", diff, e2)
        dist2 = d1 ** 2 + d2 ** 2
        w = torch.exp(-dist2 / (2.0 * min_sigma * min_sigma))
        w = torch.where((dist2 > 0) & nbh, w, torch.zeros_like(w))

        ab = sd.T @ tgt_data_c                                  # (c,Nt)
        if simval == 1:
            # -SSD(i,j) = -sqrt(sum_d (a-b)^2)/D (similarities.cpp:89-103)
            a2 = (sd * sd).sum(0)[:, None]
            b2 = (tgt_data_c * tgt_data_c).sum(0)[None, :]
            simm = -torch.sqrt(torch.clamp(a2 + b2 - 2 * ab, min=0.0)) / sd.shape[0]
        else:
            denom = sn[:, None] * tgt_norm[None, :]
            simm = torch.where(denom > 0, ab / torch.where(
                denom > 0, denom, torch.ones_like(denom)), torch.zeros_like(ab))
        wsum = w.sum(1)
        yield torch.where(wsum > 0, (w * simm).sum(1) / torch.where(
            wsum > 0, wsum, torch.ones_like(wsum)), torch.zeros_like(wsum))


def _center_columns(data: np.ndarray) -> np.ndarray:
    """meanvector removal (similarities.cpp:105-125): global mean for
    univariate rows, per-column mean across features for multivariate."""
    if data.shape[0] == 1:
        return data - data.mean()
    return data - data.mean(axis=0, keepdims=True)


def rigid_align(sph_reg: Mesh, sph_orig: Mesh, feat, cfg, iters: int,
                simval: int, verbose: bool = False, device=None) -> Mesh:
    """Annealed finite-difference ascent (run, rigid_costfunction.cpp:
    164-228). Returns the rotated source sphere. `device` None means cuda."""
    dev = resolve_device(device)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)  # noqa: E731
    src = sph_reg.copy()
    mvd = src.calculate_MeanVD()
    min_sigma = float(np.float32(mvd))
    cos_ang = float(np.float32(np.cos(2 * np.arcsin(4 * mvd / (2 * RAD)))))

    src_c = f32(_center_columns(feat.get_input_data()))
    tgt_c = f32(_center_columns(feat.get_reference_data()))
    tgt_coords = f32(sph_orig.coords)

    def cost(coords, a1, a2, a3):
        trace.count("cost_evals")
        return rigid_cost(torch.stack([a1, a2, a3]), coords, src_c,
                          tgt_coords, tgt_c, cos_ang, min_sigma, simval)

    z = torch.zeros((), dtype=torch.float32, device=dev)
    coords = f32(src.coords)
    grad_zero = cost(coords, z, z, z)
    mingrad = grad_zero
    rec_init = trace.read(grad_zero)
    rec_final = 0.0
    min_iter = 0
    spacing = cfg.gradsampling
    loop = 0
    while spacing > 0.05:
        per = torch.tensor(spacing, dtype=torch.float32, device=dev)
        step = torch.tensor(cfg.stepsize, dtype=torch.float32, device=dev)
        for it in range(1, iters + 1):
            with trace.mark("affine.step"):
                g = torch.stack([cost(coords, per, z, z) - grad_zero,
                                 cost(coords, z, per, z) - grad_zero,
                                 cost(coords, z, z, per) - grad_zero]) / per
                n = torch.linalg.norm(g)
                g = torch.where(n > 0, g / torch.where(
                    n > 0, n, torch.ones_like(n)), g)
                euler = step * g
                new_coords = sph.apply_euler(coords, euler[0], euler[1],
                                             euler[2])
                new_grad = cost(new_coords, z, z, z)

                total_it = loop * iters + it
                if trace.read(new_grad > mingrad):
                    mingrad = new_grad
                    min_iter = total_it
                    rec_final = trace.read(mingrad)
                if total_it - min_iter > 0:
                    step = step * 0.5      # revert the move, halve the step
                else:
                    coords = new_coords
                # the reference keeps the NEW cost in grad_zero even when
                # the move is reverted (rigid_costfunction.cpp:203-218)
                grad_zero = new_grad
                done = trace.read(step < 1e-3)
            if done:
                break
        loop += 1
        spacing *= 0.5

    if verbose and rec_final != 0.0:
        print(f"  rigid: improvement "
              f"{abs((rec_final - rec_init) / rec_final) * 100:.2f}%")
    out = src.copy()
    out.coords = trace.read(coords).numpy().astype(np.float64)
    return out
