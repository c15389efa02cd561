"""Per-level data preparation (featurespace.cpp:26-88): resample each
dataset onto the level's data grid, smooth, and optionally intensity- and
variance-normalise. Port of newmsm_tpu/reg/featurespace.py; the resampling
and smoothing run on the given device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .. import RAD, resolve_device
from ..core.mesh import Mesh, create_exclusion
from ..ops import histogram as hst
from ..ops import resample as rsp


@dataclass
class Featurespace:
    """Per-dataset feature matrices on a common data grid; index 0 is the
    input, index 1 the reference (featurespace.h:49-50)."""
    data: List[np.ndarray] = field(default_factory=list)   # (D, N_ico) each
    excl: List[Optional[np.ndarray]] = field(default_factory=list)
    grid: Optional[Mesh] = None

    @property
    def dim(self) -> int:
        return self.data[0].shape[0] if self.data else 0

    def get_input_data(self) -> np.ndarray:
        return self.data[0]

    def get_reference_data(self) -> np.ndarray:
        return self.data[1]

    def get_input_excl(self):
        return self.excl[0]

    def get_reference_excl(self):
        return self.excl[1]


def initialise(meshes: List[Mesh], datasets: List[np.ndarray], ico_res: int,
               sigma: List[float], exclude: bool = False, cut: bool = False,
               thresholds=(0.0, 0.0001), intensity_norm: bool = False,
               variance_norm: bool = False, device=None) -> Featurespace:
    """featurespace::initialise (featurespace.cpp:39-86). ico_res == 0
    means "use the native mesh" (no resampling grid). `device` None means
    cuda."""
    device = resolve_device(device)
    if len(meshes) != len(datasets):
        raise ValueError("number of meshes and datasets differ")

    fs = Featurespace()
    for i, (mesh, data) in enumerate(zip(meshes, datasets)):
        if ico_res > 0:
            grid = Mesh.from_icosphere(ico_res)
            grid.recentre()
            grid.true_rescale(RAD)
        else:
            grid = mesh
        carrier = Mesh(coords=mesh.coords, faces=mesh.faces,
                       data=np.asarray(data, np.float64))
        excl = (create_exclusion(carrier, thresholds[0], thresholds[1])
                if exclude or cut else None)
        resampled, excl = rsp.metric_resample(carrier, grid, excl, device)
        if sigma[i] > 0.0:
            resampled, excl = rsp.smooth_data(resampled, sigma[i], excl, device)
        fs.data.append(resampled.data)
        fs.excl.append(excl)
        if fs.grid is None:
            fs.grid = Mesh(coords=grid.coords.copy(), faces=grid.faces)

    if intensity_norm:
        for i in range(1, len(fs.data)):
            fs.data[i] = hst.multivariate_histogram_normalization(
                fs.data[i], fs.data[0], fs.excl[i], fs.excl[0])
    if variance_norm:
        for i in range(len(fs.data)):
            fs.data[i] = hst.variance_normalise(fs.data[i], fs.excl[i])
    return fs
