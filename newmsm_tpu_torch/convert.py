"""Carry the JAX package's per-level state into the port.

Each function reads the fields of a newmsm_tpu state object (or any object
or mapping with the same field names) through ``np.asarray``, so arrays
from either package, or plain numpy arrays, are accepted, and turns them
into the port's tensors on `device` (None means cuda, as everywhere in the
port): float arrays become float32, integer arrays int64, booleans stay
bool. Nothing here imports JAX or the JAX package; the tests use it to feed
both packages identical state.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from . import resolve_device
from .core.mesh import Mesh
from .ops.nearest import SearchTables
from .parallel.group_fusion import GroupIterTables, GroupLevelStatics
from .reg.costs import AnatTables, LevelTables
from .reg.optimise.fusion import FusionTables, color_group_tensors


def _field(src, name):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def tensor(a, device=None) -> torch.Tensor:
    """numpy-convertible array -> tensor (float32 / int64 / bool)."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        out = torch.from_numpy(a.copy())
    elif np.issubdtype(a.dtype, np.integer):
        out = torch.from_numpy(a.astype(np.int64))
    else:
        out = torch.from_numpy(a.astype(np.float32))
    return out.to(resolve_device(device))


def mesh(src: Any) -> Mesh:
    """newmsm_tpu.core.mesh.Mesh (or any object with coords / faces / data
    attributes) -> the port's Mesh, arrays copied."""
    data = getattr(src, "data", None)
    return Mesh(coords=np.array(src.coords, dtype=np.float64),
                faces=np.array(src.faces, dtype=np.int32),
                data=None if data is None else np.array(data, np.float64))


def search_tables(src: Any, device=None) -> SearchTables:
    """newmsm_tpu.ops.nearest.SearchTables -> the port's SearchTables."""
    return SearchTables(
        coords=tensor(_field(src, "coords"), device),
        faces=tensor(_field(src, "faces"), device),
        ring_faces=tensor(_field(src, "ring_faces"), device),
        ring_verts=tensor(_field(src, "ring_verts"), device),
        descent=tuple(tensor(d, device) for d in _field(src, "descent")),
        pristine_res=int(_field(src, "pristine_res")))


def level_tables(src: Any, device=None) -> LevelTables:
    """newmsm_tpu.reg.costs.LevelTables -> the port's LevelTables."""
    return LevelTables(
        target_tables=search_tables(_field(src, "target_tables"), device),
        **{name: tensor(_field(src, name), device)
           for name in LevelTables._fields if name != "target_tables"})


def anat_tables(src: Any, device=None) -> AnatTables:
    """newmsm_tpu.reg.costs.AnatTables -> the port's AnatTables."""
    return AnatTables(
        anat_sphere=search_tables(_field(src, "anat_sphere"), device),
        **{name: tensor(_field(src, name), device)
           for name in AnatTables._fields if name != "anat_sphere"})


def _optional(src, name, device):
    a = _field(src, name)
    return None if a is None else tensor(a, device)


def fusion_tables(src: Any, device=None) -> FusionTables:
    """newmsm_tpu.reg.optimise.fusion.FusionTables -> the port's
    FusionTables (pair tables carried when present)."""
    return FusionTables(
        vert_pair=_optional(src, "vert_pair", device),
        vert_pair_end=_optional(src, "vert_pair_end", device),
        **color_group_tensors(np.asarray(_field(src, "vgroups")),
                              np.asarray(_field(src, "vgroup_mask")),
                              resolve_device(device)),
        vert_tri=tensor(_field(src, "vert_tri"), device),
        vert_tri_corner=tensor(_field(src, "vert_tri_corner"), device))


def iteration_state(src: Mapping, device=None) -> dict:
    """A model's per-iteration inputs (the dict of
    PairwiseModel.setup_iteration: labels, rotations, patches, weights)
    -> the same dict of tensors."""
    return {k: tensor(v, device) for k, v in src.items()}


def group_statics(src: Any, device=None) -> GroupLevelStatics:
    """newmsm_tpu.parallel.group_fusion.GroupLevelStatics -> the port's
    (tensors converted, the CP search tables through `search_tables`,
    scalars carried as they are)."""
    out = {}
    for name in GroupLevelStatics._fields:
        v = _field(src, name)
        if name == "cp_search":
            out[name] = search_tables(v, device)
        elif name == "mask_w":
            out[name] = None if v is None else tensor(v, device)
        elif name in ("labels", "centre", "orig_cp", "cp_faces",
                      "tmpl_coords"):
            out[name] = tensor(v, device)
        else:
            out[name] = v
    return GroupLevelStatics(**out)


def group_iter_tables(src: Any, device=None) -> GroupIterTables:
    """newmsm_tpu.parallel.group_fusion.GroupIterTables -> the port's: the
    bucket padding of the colour groups and of the pair-incidence columns
    is dropped, and the node colouring is recovered from the groups."""
    groups = np.asarray(_field(src, "vgroups"))
    gmask = np.asarray(_field(src, "vgroup_mask"))
    keep = gmask.any(axis=1)
    if not keep[:int(keep.sum())].all():
        raise ValueError("group_iter_tables: an empty colour group lies "
                         "before a filled one")
    vert_pair = np.asarray(_field(src, "vert_pair"))
    width = max(1, int((vert_pair >= 0).sum(axis=1).max()))
    if (vert_pair[:, width:] >= 0).any():
        raise ValueError("group_iter_tables: pair incidence rows are not "
                         "left-packed")
    colors = np.full(vert_pair.shape[0], -1, np.int32)
    for c in np.nonzero(keep)[0]:
        colors[groups[c][gmask[c]]] = c
    return GroupIterTables(
        **color_group_tensors(groups[keep], gmask[keep],
                              resolve_device(device)),
        vert_tri=tensor(_field(src, "vert_tri"), device),
        vert_tri_corner=tensor(_field(src, "vert_tri_corner"), device),
        vert_pair=tensor(vert_pair[:, :width], device),
        vert_pair_end=tensor(
            np.asarray(_field(src, "vert_pair_end"))[:, :width], device),
        colors=colors)
