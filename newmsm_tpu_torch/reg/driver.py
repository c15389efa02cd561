"""Pairwise multiresolution registration driver (Mesh_registration,
mesh_registration.cpp): level loop, warp propagation, the discrete outer
loop and output writing. Port of newmsm_tpu/reg/driver.py for the AFFINE
level and the HOCR / triplet-strain discrete levels, on an explicit device.

Not ported yet (each raises NotImplementedError; ROADMAP.md queue 1): the
MCMC optimiser, regoption 1 (pairwise FastPD), regoption 5 (aMSM,
anatomical meshes), triclique and patchwise costs.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from newmsm_tpu.core import io as mio
from newmsm_tpu.core.mesh import Mesh, create_exclusion
from newmsm_tpu.reg.config import RegConfig, parse_config

from .. import RAD, resolve_device
from ..ops import histogram as hst
from ..ops import resample as rsp
from ..ops.unfold import unfold
from . import featurespace as fsp
from .model import ModelConfig, PairwiseModel
from .optimise import fusion as FU

FUSION_SEED = 7      # the JAX package's fusion start key, PRNGKey(7)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to newmsm_tpu_torch "
                               "yet (ROADMAP.md queue 1)")


class MeshRegistration:
    """Pairwise registration: input sphere + data -> warped sphere aligned to
    the reference sphere + data, computed on `device`."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.in_mesh: Optional[Mesh] = None
        self.ref_mesh: Optional[Mesh] = None
        self.in_data: Optional[np.ndarray] = None
        self.ref_data: Optional[np.ndarray] = None
        self.in_cfweight: Optional[np.ndarray] = None
        self.ref_cfweight: Optional[np.ndarray] = None
        self.transformed_mesh: Optional[Mesh] = None
        self.outdir = "./"
        self.surf_format = ".surf.gii"
        self.data_format = ".func.gii"
        self.verbose = False
        self.debug = False
        self.energy_log: list = []
        self.metrics_path: Optional[str] = None   # JSONL per-iteration metrics

    def _log_metrics(self, **kw):
        """One JSON line per event: energy, label-change share and stage
        wall-times (seconds, each ending in a device sync)."""
        if self.metrics_path:
            with open(self.metrics_path, "a") as f:
                f.write(json.dumps(kw) + "\n")

    def _clock(self) -> float:
        """Host time after the device's queued work finished."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    # ---- inputs ----------------------------------------------------------
    def set_input(self, mesh: Mesh | str):
        m = Mesh.load(mesh) if isinstance(mesh, str) else mesh.copy()
        m.recentre()
        m.true_rescale(RAD)
        self.in_mesh = m

    def set_reference(self, mesh: Mesh | str):
        m = Mesh.load(mesh) if isinstance(mesh, str) else mesh.copy()
        m.recentre()
        m.true_rescale(RAD)
        self.ref_mesh = m

    def set_input_data(self, data: np.ndarray | str):
        self.in_data = (mio.load_data(data, self.in_mesh)
                        if isinstance(data, str) else np.atleast_2d(data))

    def set_reference_data(self, data: np.ndarray | str):
        self.ref_data = (mio.load_data(data, self.ref_mesh)
                         if isinstance(data, str) else np.atleast_2d(data))

    def set_transformed(self, mesh: Mesh | str):
        self.transformed_mesh = (Mesh.load(mesh) if isinstance(mesh, str)
                                 else mesh.copy())

    def set_input_cfweighting(self, w: np.ndarray | str):
        self.in_cfweight = (mio.load_data(w, self.in_mesh)
                            if isinstance(w, str) else np.atleast_2d(w))

    def set_reference_cfweighting(self, w: np.ndarray | str):
        self.ref_cfweight = (mio.load_data(w, self.ref_mesh)
                             if isinstance(w, str) else np.atleast_2d(w))

    def set_output_format(self, fmt: str):
        self.surf_format, self.data_format = {
            "GIFTI": (".surf.gii", ".func.gii"),
            "ASCII": (".asc", ".dpv"),
            "ASCII_MAT": (".asc", ".txt"),
        }.get(fmt, (".vtk", ".txt"))

    # ---- main entry ------------------------------------------------------
    def run_multiresolutions(self, config: RegConfig | str | None = None):
        cfg = config if isinstance(config, RegConfig) else parse_config(config)
        self._check_supported(cfg)
        self.cfg = cfg
        self.verbose = self.verbose or cfg.verbose
        if self.in_mesh is None or self.in_data is None:
            raise ValueError("input mesh and data must be set")
        if self.ref_mesh is None:
            self.ref_mesh = self.in_mesh.copy()
        if self.ref_data is None:
            self.ref_data = self.in_data.copy()

        self.sph_reg: Optional[Mesh] = None
        self.model = None
        for level in range(cfg.levels):
            self.level = level + 1
            if self.verbose:
                print(f"-- level {self.level}/{cfg.levels} "
                      f"({cfg.cost[level]}, datagrid {cfg.datagrid[level]})")
            t0 = self._clock()
            self._initialize_level(level)
            self._evaluate(level)
            self._log_metrics(event="level", level=self.level,
                              cost=cfg.cost[level],
                              wall_s=round(self._clock() - t0, 4))
        self._write_outputs()
        return self.sph_reg

    @staticmethod
    def _check_supported(cfg: RegConfig):
        discrete = any(c not in ("RIGID", "AFFINE") for c in cfg.cost)
        if discrete and cfg.dopt == "MCMC":
            raise _not_ported("the MCMC optimiser (--dopt=MCMC)")
        if discrete and cfg.dopt not in ("HOCR", "FastPD"):
            raise ValueError(f"unknown optimiser {cfg.dopt}")
        if discrete and cfg.regmode not in (2, 3):
            raise _not_ported(f"--regoption {cfg.regmode}")
        if cfg.triclique:
            raise _not_ported("--triclique")
        if cfg.patchwise:
            raise _not_ported("--patchwise")

    # ---- per-level -------------------------------------------------------
    def _initialize_level(self, level: int):
        cfg = self.cfg
        self.feat = fsp.initialise(
            [self.in_mesh, self.ref_mesh], [self.in_data, self.ref_data],
            cfg.datagrid[level], [cfg.sigma_in[level], cfg.sigma_ref[level]],
            exclude=cfg.exclude, cut=cfg.cut, thresholds=tuple(cfg.cutthreshold),
            intensity_norm=cfg.intensity_norm, variance_norm=cfg.variance_norm,
            device=self.device)
        self.sph_orig = Mesh(coords=self.feat.grid.coords.copy(),
                             faces=self.feat.grid.faces)
        # downsampled cfweightings (mesh_registration.cpp:334-350)
        self.sphin_cfw = self._downsample_cfw(self.in_cfweight,
                                              self.feat.get_input_excl())
        self.sphref_cfw = self._downsample_cfw(self.ref_cfweight,
                                               self.feat.get_reference_excl())
        if cfg.cost[level] in ("RIGID", "AFFINE"):
            self.model = None
            return
        mc = ModelConfig(
            simval=cfg.simval[level], reglambda=cfg.reglambda[level],
            sg_res=cfg.sampgrid[level],
            regmode=cfg.regmode, mu=cfg.shearmod, kappa=cfg.bulkmod,
            k_exp=cfg.k_exponent, rexp=cfg.regexp, cprange=cfg.cprange,
            percentile=cfg.percentile, rescale_labels=cfg.rescaleL,
            multivariate=self.feat.dim > 1, fixnan=cfg.fixnan)
        control = Mesh.from_icosphere(cfg.cpgrid[level])
        control.recentre()
        control.true_rescale(RAD)
        target = Mesh(coords=self.sph_orig.coords.copy(),
                      faces=self.sph_orig.faces)
        self.model = PairwiseModel(mc, control, self.sph_orig, target,
                                   self.feat.get_input_data(),
                                   self.feat.get_reference_data(),
                                   device=self.device)

    def _downsample_cfw(self, cfw, excl):
        src = cfw if cfw is not None else (None if excl is None
                                           else excl[None, :])
        if src is None:
            return np.ones((1, self.sph_orig.nvertices))
        carrier = Mesh(coords=self.in_mesh.coords, faces=self.in_mesh.faces,
                       data=np.atleast_2d(src))
        out, _ = rsp.nearest_neighbour_interpolation(carrier, self.sph_orig,
                                                     excl, self.device)
        return out.data

    def _evaluate(self, level: int):
        self.sph_reg = self._project_cpgrid()
        if self.cfg.cost[level] in ("RIGID", "AFFINE"):
            from .rigid import rigid_align
            self.sph_reg = rigid_align(
                self.sph_reg, self.sph_orig, self.feat, self.cfg,
                iters=self.cfg.iters[level], simval=self.cfg.simval[level],
                verbose=self.verbose, device=self.device)
        else:
            self._run_discrete_opt(level)

    def _warp(self, sphere, frm, to):
        return rsp.sphere_project_warp(sphere, frm, to, self.device)

    def _unfold(self, mesh):
        return unfold(mesh, self.verbose, device=self.device)

    def _project_cpgrid(self) -> Mesh:
        """Warp propagation across levels (project_CPgrid,
        mesh_registration.cpp:131-162)."""
        sph_in = Mesh(coords=self.sph_orig.coords.copy(),
                      faces=self.sph_orig.faces)
        if self.level == 1:
            if self.transformed_mesh is not None:
                sph_in = self._warp(sph_in, self.in_mesh, self.transformed_mesh)
                if self.model is not None:
                    self.model.cp_grid = self._unfold(self._warp(
                        self.model.cp_grid, self.in_mesh,
                        self.transformed_mesh))
        elif self.sph_reg is not None:
            prev = self.sph_reg
            icotmp = Mesh.from_icosphere(prev.get_resolution())
            icotmp.true_rescale(RAD)
            incurrent = self._warp(self.in_mesh, icotmp, prev)
            sph_in = self._warp(sph_in, self.in_mesh, incurrent)
            if self.model is not None:
                self.model.cp_grid = self._unfold(self._warp(
                    self.model.cp_grid, self.in_mesh, incurrent))
        return self._unfold(sph_in)

    def _combine_weighting(self) -> np.ndarray:
        """(combine_weighting, mesh_registration.cpp:234-248)."""
        n = self.sph_reg.nvertices
        if self.in_cfweight is not None and self.ref_cfweight is not None:
            carrier = Mesh(coords=self.model.target.coords,
                           faces=self.model.target.faces, data=self.sphref_cfw)
            resampled = rsp.metric_resample(carrier, self.sph_reg,
                                            device=self.device)[0].data
            a, b = self.sphin_cfw, resampled
            rows = min(a.shape[0], b.shape[0])
            out = (a if a.shape[0] >= b.shape[0] else b).copy()
            out[:rows] = (a[:rows] + b[:rows]) / 2.0
            return out
        return np.ones((1, n))

    def _run_discrete_opt(self, level: int):
        """HOCR fusion with the triplet-strain regulariser
        (mesh_registration.cpp:164-232)."""
        cfg = self.cfg
        model = self.model
        dev = self.device
        energy = 0.0
        for it in range(cfg.iters[level]):
            t_setup = self._clock()
            cfw = self._combine_weighting()
            model.source = self.sph_reg      # reset_meshspace
            s = model.setup_iteration(cfw)
            if self.debug:
                self.sph_reg.save(self._out(f"SOURCE-{self.level}-{it}.surf.gii"))
                model.cp_grid.save(self._out(f"CPgrid-{self.level}-{it}.surf.gii"))
                if it == 0:
                    model.target.save(self._out(f"TARGET-{self.level}.surf.gii"))

            t_opt = self._clock()
            unary = model.unary(s).T                        # (L,K)
            t_unary = self._clock()
            tfn = model.triplet_combo_fn(s)
            labeling = FU.fusion_optimize(
                torch.as_tensor(model.labeling).to(dev), unary,
                model.tables.triplets, model.fusion_tables, tfn,
                model.num_labels,
                generator=torch.Generator().manual_seed(FUSION_SEED))
            newenergy = float(FU.fusion_energy(labeling, unary,
                                               model.tables.triplets, tfn))
            labeling = labeling.cpu().numpy()
            t_done = self._clock()
            self.energy_log.append((self.level, it, newenergy))
            changed = float((labeling != 0).mean())
            if self.verbose:
                print(f"  iter {it}: energy {newenergy:.6f} "
                      f"({changed:.0%} nodes moved)  "
                      f"[setup {t_opt - t_setup:.2f}s opt {t_done - t_opt:.2f}s]")
            self._log_metrics(event="iter", level=self.level, iter=it,
                              energy=newenergy, changed=changed,
                              cps=int(labeling.shape[0]),
                              labels=model.num_labels, pmax=model.pmax,
                              setup_s=round(t_opt - t_setup, 4),
                              unary_s=round(t_unary - t_opt, 4),
                              fusion_s=round(t_done - t_unary, 4),
                              opt_s=round(t_done - t_opt, 4))

            # convergence (mesh_registration.cpp:206-214)
            if it > 2 and (it - 1) % 2 == 0 and energy - newenergy < 0.001:
                break

            prev_cp = model.cp_grid.copy()
            model.apply_labeling(labeling, s)
            self.sph_reg = self._warp(self.sph_reg, prev_cp, model.cp_grid)
            model.cp_grid = self._unfold(model.cp_grid)
            self.sph_reg = self._unfold(self.sph_reg)
            energy = newenergy
            self._log_metrics(event="warp", level=self.level, iter=it,
                              warp_s=round(self._clock() - t_done, 4))

    # ---- outputs ---------------------------------------------------------
    def _out(self, name: str) -> str:
        """`outdir` is a basename PREFIX like the reference's -o; a trailing
        separator makes it a directory."""
        d = os.path.dirname(self.outdir)
        if d:
            os.makedirs(d, exist_ok=True)
        return self.outdir + name

    def _write_outputs(self):
        # transform (mesh_registration.cpp:352-356)
        self.warped_input = self._warp(self.in_mesh, self.sph_orig,
                                       self.sph_reg)
        self.warped_input.save(self._out("sphere.reg" + self.surf_format))
        self.sph_reg.save(self._out("sphere.LR.reg" + self.surf_format))
        self._save_transformed_data()

    def _save_transformed_data(self):
        """(save_transformed_data, mesh_registration.cpp:358-408)."""
        cfg = self.cfg
        data = self.in_data.copy()
        in_excl = ref_excl = None
        if cfg.exclude:
            in_excl = create_exclusion(Mesh(coords=self.in_mesh.coords,
                                            faces=self.in_mesh.faces,
                                            data=data), *cfg.cutthreshold)
            ref_excl = create_exclusion(Mesh(coords=self.ref_mesh.coords,
                                             faces=self.ref_mesh.faces,
                                             data=self.ref_data.copy()),
                                        *cfg.cutthreshold)
        if cfg.intensity_norm:
            data = hst.multivariate_histogram_normalization(
                data, self.ref_data.copy(), in_excl, ref_excl)
        carrier = Mesh(coords=self.warped_input.coords,
                       faces=self.warped_input.faces, data=data)
        out, _ = rsp.metric_resample(carrier, self.ref_mesh, in_excl,
                                     self.device)
        out.save(self._out("transformed_and_reprojected" + self.data_format))
        self.transformed_data = out.data
