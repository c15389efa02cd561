"""Carry the JAX package's per-level state into the port.

Each function reads the fields of a newmsm_tpu state object (or any object
or mapping with the same field names) through ``np.asarray``, so arrays
from either package, or plain numpy arrays, are accepted, and turns them
into the port's tensors on `device`: float arrays become float32, integer
arrays int64, booleans stay bool. Nothing here imports JAX; the tests use
it to feed both packages identical state.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .ops.nearest import SearchTables
from .reg.costs import LevelTables
from .reg.optimise.fusion import FusionTables, color_group_tensors


def _field(src, name):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def tensor(a, device="cpu") -> torch.Tensor:
    """numpy-convertible array -> tensor (float32 / int64 / bool)."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        out = torch.from_numpy(a.copy())
    elif np.issubdtype(a.dtype, np.integer):
        out = torch.from_numpy(a.astype(np.int64))
    else:
        out = torch.from_numpy(a.astype(np.float32))
    return out.to(device)


def search_tables(src: Any, device="cpu") -> SearchTables:
    """newmsm_tpu.ops.nearest.SearchTables -> the port's SearchTables."""
    return SearchTables(
        coords=tensor(_field(src, "coords"), device),
        faces=tensor(_field(src, "faces"), device),
        ring_faces=tensor(_field(src, "ring_faces"), device),
        ring_verts=tensor(_field(src, "ring_verts"), device),
        descent=tuple(tensor(d, device) for d in _field(src, "descent")),
        pristine_res=int(_field(src, "pristine_res")))


def level_tables(src: Any, device="cpu") -> LevelTables:
    """newmsm_tpu.reg.costs.LevelTables -> the port's LevelTables (the
    fields of the pairwise regulariser are not carried)."""
    return LevelTables(
        target_tables=search_tables(_field(src, "target_tables"), device),
        **{name: tensor(_field(src, name), device)
           for name in LevelTables._fields if name != "target_tables"})


def fusion_tables(src: Any, device="cpu") -> FusionTables:
    """newmsm_tpu.reg.optimise.fusion.FusionTables (triplet path) -> the
    port's FusionTables."""
    return FusionTables(
        groups=color_group_tensors(np.asarray(_field(src, "vgroups")),
                                   np.asarray(_field(src, "vgroup_mask")),
                                   device),
        vert_tri=tensor(_field(src, "vert_tri"), device),
        vert_tri_corner=tensor(_field(src, "vert_tri_corner"), device))


def iteration_state(src: Mapping, device="cpu") -> dict:
    """A model's per-iteration inputs (the dict of
    PairwiseModel.setup_iteration: labels, rotations, patches, weights)
    -> the same dict of tensors."""
    return {k: tensor(v, device) for k, v in src.items()}
