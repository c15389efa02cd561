"""Mesh untangling (fold removal).

Port of newmsm_tpu/ops/unfold.py (reference reg_tools.cpp:118-177): a
vertex is folded when an incident face normal deviates from its first
incident face normal by dot <= 0.5; folded vertices of one colour group
move together along the negative area gradient with step halving, or to
their 1-ring centroid when no step unfolds them. Sweeps repeat until no
fold remains, up to 1000, checked every 25 sweeps with the JAX package's
stall-break rule (fold count not improving for 4 checks AND max motion
below 1e-3), so both packages stop at the same sweep.

The loop condition is read on the host after each sweep (one device sync
per sweep). `unfold_coords` is the one sweep loop, on tensors; `unfold` wraps
it for numpy meshes.
"""
from __future__ import annotations


import numpy as np
import torch

from .. import RAD, resolve_device, trace
from ..core import spherical as sph
from ..core.mesh import Mesh
from ..reg.optimise.coloring import color_groups, vertex_coloring_from_faces


def _face_normals(coords, faces):
    return sph.tri_normal(coords[faces[:, 0]], coords[faces[:, 1]],
                          coords[faces[:, 2]])


def _folded_mask(coords, faces, tri_idx):
    """check_for_intersections per vertex (reg_tools.cpp:118-129)."""
    fn = _face_normals(coords, faces)                       # (T,3)
    first = fn[tri_idx[:, 0]]                               # (N,3)
    gathered = fn[tri_idx.clamp(0, fn.shape[0] - 1)]        # (N,MT,3)
    dots = (gathered * first[:, None, :]).sum(-1)
    return ((dots <= 0.5) & (tri_idx >= 0)).any(dim=1)


def _area_gradients(coords, faces, tri_idx):
    """spatialgradient (reg_tools.cpp:95-116): per vertex, the sum over
    incident triangles of the area gradient wrt that vertex."""
    fv = faces[tri_idx.clamp(0, faces.shape[0] - 1)]        # (N,MT,3)
    vid = torch.arange(coords.shape[0], device=coords.device)[:, None]
    # rotate face vertices so the own vertex comes last
    is0 = fv[..., 0] == vid
    is1 = fv[..., 1] == vid
    a = torch.where(is0, fv[..., 1], torch.where(is1, fv[..., 2], fv[..., 0]))
    b = torch.where(is0, fv[..., 2], torch.where(is1, fv[..., 0], fv[..., 1]))
    c = torch.where(is0, fv[..., 0], torch.where(is1, fv[..., 1], fv[..., 2]))
    va, vb, vc = coords[a], coords[b], coords[c]

    # computeGradientOfBarycentricTriangle (reg_tools.cpp:59-93)
    s1 = sph.normalize(vc - va, eps=1e-10)
    s2 = sph.normalize(vb - va, eps=1e-10)
    n_tri = sph.normalize(torch.linalg.cross(s1, s2, dim=-1), eps=1e-10)
    n_edge = torch.linalg.cross(s2, n_tri, dim=-1)
    flip = ((s1 * n_edge).sum(-1) < 0)[..., None]
    n_edge = torch.where(flip, -n_edge, n_edge)
    base = torch.linalg.norm(vb - va, dim=-1)
    dA = n_edge * (0.5 * base)[..., None] * (tri_idx >= 0)[..., None]
    return dA.sum(1)                                        # (N,3)


def _sweep(coords, faces, tri_idx, fv, color_masks, nbr_idx, steps):
    """One sweep: each colour group in turn updates its folded vertices
    (the candidate steps of every vertex are evaluated at once)."""
    N = coords.shape[0]
    S = steps.shape[0]
    vid = torch.arange(N, device=coords.device)[:, None, None]
    own = [(fv[..., i] == vid[..., 0])[:, None, :, None] for i in range(3)]
    valid = (tri_idx >= 0)[:, None, :]
    nb_ok = (nbr_idx >= 0)
    nb_cnt = torch.clamp(nb_ok.sum(1), min=1)[:, None].to(coords.dtype)
    for in_group in color_masks:
        folded = _folded_mask(coords, faces, tri_idx) & in_group
        grads = _area_gradients(coords, faces, tri_idx)
        cand = coords[:, None, :] - grads[:, None, :] * steps[None, :, None]
        cand = sph.normalize(cand) * RAD                    # (N,S,3)

        # incident face normals with only the own vertex moved, per step
        cand_e = cand[:, :, None, :]                        # (N,S,1,3)
        p = [torch.where(own[i], cand_e, coords[fv[..., i]][:, None])
             for i in range(3)]                             # (N,S,MT,3)
        fnl = sph.tri_normal(p[0], p[1], p[2])
        dots = (fnl * fnl[:, :, :1, :]).sum(-1)
        still = ((dots <= 0.5) & valid).any(dim=2)          # (N,S)
        ok = ~still
        any_ok = ok.any(dim=1)
        first_ok = torch.argmax(ok.to(torch.int32), dim=1)
        sel = torch.where(any_ok, first_ok, torch.full_like(first_ok, S - 1))
        chosen = cand[torch.arange(N, device=coords.device), sel]

        nb = coords[nbr_idx.clamp(0, N - 1)] * nb_ok[..., None]
        centroid = sph.normalize(nb.sum(1) / nb_cnt) * RAD
        chosen = torch.where(any_ok[:, None], chosen, centroid)
        coords = torch.where(folded[:, None], chosen, coords)
    return coords


@trace.cached()
def _vertex_groups_np(faces_key: bytes, nverts: int, nfaces: int):
    faces = np.frombuffer(faces_key, dtype=np.int32).reshape(nfaces, 3)
    return color_groups(vertex_coloring_from_faces(faces, nverts))


class UnfoldTopology:
    """Device tensors of one mesh topology for `unfold_coords`: faces (T,3),
    tri_idx (N,MT) and nbr_idx (N,MN) (-1 padded), all int64. The vertex
    colour masks are built at the first sweep that needs them (a fold-free
    mesh never pays for the colouring)."""

    def __init__(self, faces: np.ndarray, nverts: int, tri_idx: np.ndarray,
                 nbr_idx: np.ndarray, device):
        self.device = resolve_device(device)
        self._faces_np = np.ascontiguousarray(faces, np.int32)
        self.nverts = int(nverts)
        self.faces = torch.as_tensor(self._faces_np.astype(np.int64)).to(
            self.device)
        self.tri_idx = torch.as_tensor(tri_idx.astype(np.int64)).to(self.device)
        self.nbr_idx = torch.as_tensor(nbr_idx.astype(np.int64)).to(self.device)
        self.fv = self.faces[self.tri_idx.clamp(0, self.faces.shape[0] - 1)]
        self._masks = None

    @classmethod
    def from_mesh(cls, mesh: Mesh, device=None) -> "UnfoldTopology":
        nbr_idx, _, tri_idx, _ = mesh.adjacency
        return cls(mesh.faces, mesh.nvertices, tri_idx, nbr_idx, device)

    @property
    def color_masks(self):
        """(C,N) bool: vertex colour groups (no two share a face)."""
        if self._masks is None:
            groups, mask = _vertex_groups_np(
                self._faces_np.tobytes(), self.nverts, self._faces_np.shape[0])
            out = np.zeros((groups.shape[0], self.nverts), bool)
            for c in range(groups.shape[0]):
                out[c, groups[c][mask[c]]] = True
            self._masks = torch.from_numpy(out).to(self.device)
        return self._masks


def unfold_coords(coords, topo: UnfoldTopology, max_iter: int = 1000,
                  chunk: int = 25, n_steps: int = 11,
                  stall_break: bool = True):
    """Untangle coords (N,3) float32 on topo's device: sweeps until no fold
    remains or `max_iter`. The fold count is read on the host after each
    sweep. With `stall_break`, every `chunk` sweeps the stall rule of the
    JAX package's `unfold` applies (fold count not improving for 4 checks
    AND max motion below 1e-3); without it the loop is the JAX package's
    `unfold_kernel` (count and cap only), which its groupwise apply stage
    calls. Returns (coords, residual folds, sweeps)."""
    steps = 2.0 ** -torch.arange(n_steps, dtype=torch.float32,
                                 device=coords.device)

    def n_folds(c):
        return int(_folded_mask(c, topo.faces, topo.tri_idx).sum())

    it_total = 0
    nf = n_folds(coords)
    stalled = 0
    best_nf = None
    while it_total < max_iter and nf > 0:
        prev = coords
        budget = min(chunk, max_iter - it_total)
        it = 0
        while nf > 0 and it < budget:
            coords = _sweep(coords, topo.faces, topo.tri_idx, topo.fv,
                            topo.color_masks, topo.nbr_idx, steps)
            it += 1
            nf = n_folds(coords)
        it_total += it
        if nf == 0 or it < chunk or not stall_break:
            continue
        # stall break (JAX package unfold, ops/unfold.py:203-222): fold
        # count not improving for 4 checks while the vertices stopped moving
        motion = float((coords - prev).abs().max())
        if best_nf is None or nf < best_nf:
            best_nf = nf
            stalled = 0
        elif motion < 1e-3:
            stalled += 1
            if stalled >= 4:
                break
        else:
            stalled = 0
    return coords, nf, it_total


def unfold(mesh: Mesh, verbose: bool = False, max_iter: int = 1000,
           chunk: int = 25, n_steps: int = 11, device=None) -> Mesh:
    """Returns a fold-free copy of `mesh` (or the stalled residual).
    `device` None means cuda."""
    topo = UnfoldTopology.from_mesh(mesh, device)
    coords = torch.as_tensor(mesh.coords, dtype=torch.float32).to(topo.device)
    coords, nf, it_total = unfold_coords(coords, topo, max_iter, chunk,
                                         n_steps)
    if verbose and it_total > 0:
        print(f"unfold: {it_total} sweeps, {nf} residual folds")
    out = mesh.copy()
    out.coords = coords.cpu().numpy().astype(np.float64)
    return out


def count_folds(mesh: Mesh, device=None) -> int:
    """Number of folded vertices of `mesh` (`device` None means cuda)."""
    _, _, tri_idx, _ = mesh.adjacency
    dev = resolve_device(device)
    return int(_folded_mask(
        torch.as_tensor(mesh.coords, dtype=torch.float32).to(dev),
        torch.as_tensor(mesh.faces.astype(np.int64)).to(dev),
        torch.as_tensor(tri_idx.astype(np.int64)).to(dev)).sum())
