"""A cell's inputs, made from `--seed` with the frozen generator and handed
to the program as its own Mesh objects (or files), with the same arrays
kept for the reference."""
from __future__ import annotations

import numpy as np

from . import synth


class Inputs:
    """The template and a run's subjects on the traffic's icosphere: the
    traffic's fixed pool, ordered by `seed` (synth.arrange). `warm` and
    `units` are lists of id lists. Arrays: coords (N,3), faces (T,3),
    template_data (2,N), data[sid] (2,N)."""

    def __init__(self, traffic: dict, seed: int):
        self.res = res = traffic["subject_res"]
        self.coords, self.faces = synth.icosphere(res)
        self.template_data = synth.template_data(res)
        self.warm, self.units = synth.arrange(
            traffic["pool_seed"], seed, traffic["subjects_per_unit"],
            traffic["warmup"]["units"], traffic["units"])
        self.data = {sid: synth.subject_data(res, sid)
                     for unit in self.warm + self.units for sid in unit}

    def mesh(self, data=None):
        """The program's Mesh of the icosphere (with `data` if given).
        Checks that it is the program's own icosphere, vertex for vertex,
        so that the program takes its pristine-icosphere path."""
        from newmsm_tpu_torch.core.mesh import Mesh
        own = Mesh.from_icosphere(self.res)
        own.true_rescale()
        if not (np.array_equal(own.faces, self.faces)
                and np.abs(own.coords - self.coords).max() < 1e-9):
            raise RuntimeError("the frozen icosphere differs from the "
                               "program's: the inputs would not be what "
                               "users hand it")
        return Mesh(coords=self.coords.copy(), faces=self.faces.copy(),
                    data=None if data is None else np.atleast_2d(data).copy())

    def template(self) -> dict:
        return {"coords": self.coords, "faces": self.faces,
                "data": self.template_data}

    def subject(self, sid: int) -> dict:
        return {"sid": sid, "coords": self.coords, "faces": self.faces,
                "data": self.data[sid]}
