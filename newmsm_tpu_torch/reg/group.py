"""Groupwise registration (Group_Mesh_registration + DiscreteGroupModel +
DiscreteGroupCostFunction; group_mesh_registration.cpp, DiscreteGroupModel.cpp,
DiscreteGroupCostFunction.cpp). Port of newmsm_tpu/reg/group.py.

N subjects' spheres are co-registered simultaneously: MRF nodes are
(subject, control-point) pairs, triplets are per-subject CP faces with strain
regularisation (scaled by subcorr = 0.1*S), and pairs are cross-subject
correspondences whose cost is the similarity of the subjects' label-deformed
feature maps over the overlap of their template-space patches. HOCR fusion
moves only (the reference rejects other optimisers, group_...cpp:85-89).

The subject axis is the distribution axis. One process per rank, each
with one explicit device: over the process group it is given (the CLI
passes the world under torchrun; parallel/multihost.py) rank r of W owns
the contiguous subjects process_subject_slice(S), loads only those (and
subject 0, the histogram reference of intensity_norm), keeps their state
subject-major on its device across the iterations of a level
(`label_maps (S/W,L,D,Nt)`, CP coords (S/W,K,3)), and writes only their
outputs. Every heavy per-iteration stage runs through the subject-sharded
optimiser of parallel/group_fusion.py; given no group the process is the
one rank of the same program, so the rank count never changes a
labeling, an energy or a sphere (tests/test_torch_sharded.py).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from .. import RAD, resolve_device, trace
from ..core import io as mio
from ..core.mesh import Mesh
from ..ops import resample as rsp
from ..ops.nearest import build_tables
from ..ops.unfold import unfold
from ..ops import icm, labelmap, locate
from ..parallel import group_fusion as GF
from ..parallel import multihost as mh
from . import featurespace as fsp
from .config import RegConfig, parse_config
from .sampling_grid import build_sampling_grid


def choose_maps_exchange(maps_bytes: int, device, comm) -> str:
    """The maps exchange that 'auto' picks, the same on every rank of
    `comm`: 'ring' when on some rank the gathered maps tensors
    (`maps_bytes` each) of all the ranks that share its device would take
    more than half of that device's free memory, else 'gather'. The other
    half is left to the fusion call's temporaries, which its fixed chunks
    bound (3.2-3.4 GiB a rank in PERF.md's 6-subject ico-6 cohort)."""
    need = maps_bytes * mh.ranks_on_device(device)
    ring = need > mh.free_bytes(device) // 2
    flag = comm.max(torch.tensor([int(ring)], device=device))
    return "ring" if int(flag[0]) else "gather"


class GroupMeshRegistration:
    """Groupwise registration of S spheres + data to a template space,
    computed on `device` (None means cuda), over the ranks of `group` (a
    torch.distributed process group, e.g. dist.group.WORLD; None: this
    process alone, whether or not a process group is up)."""

    def __init__(self, device=None, group=None):
        self.device = resolve_device(device)
        self.comm = mh.SubjectComm(group)
        self.meshes: List[Mesh] = []
        self.datasets: List[np.ndarray] = []
        self.template: Optional[Mesh] = None
        self.mask: Optional[np.ndarray] = None
        self.profile_dir: Optional[str] = None    # torch.profiler trace dir
        self.outdir = "./"
        self.surf_format = ".surf.gii"
        self.data_format = ".func.gii"
        self.verbose = False
        self.debug = False
        self.energy_log: list = []
        # JSONL events and spans of the run (trace.py), written by rank 0;
        # None: tracing off (on on every rank when any rank sets it)
        self.metrics_path: Optional[str] = None
        # alpha -> (n_restarts, S*K) int tensor: the fusion optimiser's
        # random starts, injected (a test feeds both packages the same
        # draws); None draws them from a generator seeded with FUSION_SEED
        self.fusion_random_starts = None
        # cross-subject maps exchange: 'gather' (one all-gather a fusion
        # call; every rank holds the (S,L,D,Nt) maps tensor), 'ring' (a
        # rank's maps memory O(S/W), W//2 ring exchanges an alpha step), or
        # 'auto' (choose_maps_exchange: ring only when the gathered tensors
        # would not fit the device); the same bits either way
        self.maps_exchange = "auto"
        self.owned = slice(None)

    # ---- inputs ----------------------------------------------------------
    def set_inputs(self, meshes: List[Mesh] | List[str]):
        self._raw_meshes = list(meshes)
        self.meshes = []

    def set_data_list(self, data: List[np.ndarray] | List[str]):
        self._raw_data = list(data)
        self.datasets = []

    def _load_subject(self, s: int):
        m = self._raw_meshes[s]
        mesh = Mesh.load(m) if isinstance(m, str) else m.copy()
        mesh.recentre()
        mesh.true_rescale(RAD)
        d = self._raw_data[s]
        data = (mio.load_data(d, mesh) if isinstance(d, str)
                else np.atleast_2d(d))
        return mesh, data

    def _materialise_inputs(self, cfg):
        """Fill self.meshes / self.datasets (None for subjects this rank
        does not own) and set the ownership slice: the multi-rank form of
        the reference's per-host SLURM file lists (run_gMSM.sh:31-38)."""
        S = len(self._raw_meshes)
        self.owned = mh.process_subject_slice(S, self.comm)
        need = set(range(S)[self.owned])
        if cfg.intensity_norm:
            need.add(0)            # histogram-matching reference subject
        self.meshes = [None] * S
        self.datasets = [None] * S
        for s in sorted(need):
            self.meshes[s], self.datasets[s] = self._load_subject(s)

    def _owned_ids(self) -> List[int]:
        return list(range(len(self.meshes))[self.owned])

    def registered_spheres(self) -> List[Mesh]:
        """Every subject's registered data-grid sphere, on every rank of
        the comm (sph_reg holds only this rank's own): a collective."""
        coords = self.comm.all_gather_arrays(
            [self.sph_reg[s].coords for s in self._owned_ids()])
        return [Mesh(coords=c, faces=self.sph_orig.faces) for c in coords]

    def set_template(self, mesh: Mesh | str):
        m = Mesh.load(mesh) if isinstance(mesh, str) else mesh.copy()
        m.recentre()
        m.true_rescale(RAD)
        self.template = m

    def set_mask(self, mask: np.ndarray | str):
        self.mask = (mio.load_data(mask, self.template)[0]
                     if isinstance(mask, str) else np.asarray(mask))

    # ---- main ------------------------------------------------------------
    def run_multiresolutions(self, config: RegConfig | str | None = None):
        # tracing guards collectives, so every rank takes one decision
        on = bool(self.metrics_path)
        if self.comm.world > 1:
            on = bool(int(self.comm.max(torch.tensor(
                [int(on)], device=self.device))[0]))
        path = self.metrics_path if self.comm.rank == 0 else None
        with trace.run(path, self.device, on=on):
            if not self.profile_dir:
                return self._run_multiresolutions(config)
            # one trace of the whole run (host ops, and the card's kernels
            # when on cuda), as Chrome trace JSON: chrome://tracing or
            # Perfetto
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(self.profile_dir, exist_ok=True)
            with profile(activities=activities) as prof:
                out = self._run_multiresolutions(config)
            name = ("trace.json" if self.comm.world == 1
                    else f"trace-rank{self.comm.rank}.json")
            prof.export_chrome_trace(os.path.join(self.profile_dir, name))
            return out

    def _run_multiresolutions(self, config: RegConfig | str | None = None):
        cfg = config if isinstance(config, RegConfig) else parse_config(config)
        self.cfg = cfg
        S = len(self._raw_meshes)
        if len(self._raw_data) != S:
            raise ValueError("meshes/data list length mismatch")
        if S < 2:
            raise ValueError("groupwise mode needs at least 2 subjects")
        if self.template is None:
            raise ValueError("groupwise mode needs a template sphere")
        self._materialise_inputs(cfg)

        self.sph_reg: Optional[List[Mesh]] = None
        for level in range(cfg.levels):
            self.level = level + 1
            if cfg.cost[level] in ("RIGID", "AFFINE"):
                raise ValueError(
                    "AFFINE/RIGID is not supported in groupwise mode")
            if self.verbose and self.comm.rank == 0:
                print(f"-- groupwise level {self.level}/{cfg.levels}")
            with trace.span("level") as span:
                self._initialize_level(level)
                self._evaluate(level)
            trace.event("level", level=self.level, cost=cfg.cost[level],
                        init_s=round(self._init_s, 4),
                        wall_s=round(span.wall_s, 4))

        with trace.span("outputs") as span:
            self._write_outputs()
        trace.event("outputs", wall_s=round(span.wall_s, 4))
        if trace.active():
            # per rank, from the kernels' tallies: K1's launches in this
            # process and the most queries of one, the peak device memory
            # (-1 on the CPU), K2's and K4's launches in this process
            dev = self.device
            peak = torch.cuda.max_memory_allocated(dev) \
                if dev.type == "cuda" else -1
            k1, k2 = locate.SEAM.tally, icm.SEAM.tally
            per_rank = self.comm.all_gather(torch.tensor(
                [[k1["kernel"], k1["largest"], peak, k2["kernel"],
                  labelmap.SEAM.tally["kernel"]]],
                dtype=torch.int64, device=dev))
            trace.event("ranks", devices=self.comm.world,
                        locate_launches=per_rank[:, 0].tolist(),
                        locate_largest=per_rank[:, 1].tolist(),
                        peak_device_bytes=per_rank[:, 2].tolist(),
                        icm_launches=per_rank[:, 3].tolist(),
                        labelmap_launches=per_rank[:, 4].tolist())
        return self.sph_reg

    # ---- level setup -----------------------------------------------------
    def _f32(self, a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(
            self.device)

    def _initialize_level(self, level: int):
        with trace.span("level.init") as span:
            self._setup_level(level)
        self._init_s = span.wall_s

    def _setup_level(self, level: int):
        cfg = self.cfg
        dev = self.device
        S = len(self.meshes)
        # featurespace over the subjects this rank owns, with subject 0
        # first when intensity_norm needs its histogram reference
        ids = self._owned_ids()
        prep = ids if (not cfg.intensity_norm or ids[0] == 0) \
            else [0] + ids
        self.feat = fsp.initialise(
            [self.meshes[s] for s in prep], [self.datasets[s] for s in prep],
            cfg.datagrid[level], [cfg.sigma_in[level]] * len(prep),
            exclude=cfg.exclude, cut=cfg.cut,
            thresholds=tuple(cfg.cutthreshold),
            intensity_norm=cfg.intensity_norm, variance_norm=cfg.variance_norm,
            device=dev)
        self._feat_row = {s: i for i, s in enumerate(prep)}
        self.sph_orig = Mesh(coords=self.feat.grid.coords.copy(),
                             faces=self.feat.grid.faces)

        control = Mesh.from_icosphere(cfg.cpgrid[level])
        control.recentre()
        control.true_rescale(RAD)
        self.control = control
        K = control.nvertices

        self.max_label_dist = 0.5 * control.calculate_MaxVD()
        self.sampling = build_sampling_grid(cfg.sampgrid[level],
                                            self.max_label_dist)
        self.centre = self._f32(self.sampling.centre)

        trip = np.sort(control.faces.astype(np.int32), axis=1)
        self.cp_triplets = trip

        # per-subject state (owned subjects only; None elsewhere)
        if self.sph_reg is None or \
                self.sph_reg[ids[0]].nvertices != self.sph_orig.nvertices:
            prev = self.sph_reg
            self.sph_reg = [None] * S
            for s in ids:
                self.sph_reg[s] = Mesh(coords=self.sph_orig.coords.copy(),
                                       faces=self.sph_orig.faces)
            if prev is not None:
                # project previous level's warps onto the new data grid
                icotmp = Mesh.from_icosphere(prev[ids[0]].get_resolution())
                icotmp.true_rescale(RAD)
                for s in ids:
                    warped = rsp.sphere_project_warp(self.sph_orig, icotmp,
                                                     prev[s], dev)
                    self.sph_reg[s] = unfold(warped, self.verbose, device=dev)
        self.cp_grids = [control.copy() if s in ids else None
                         for s in range(S)]

        self.template_tables = build_tables(self.template.coords,
                                            self.template.faces,
                                            self.template.adjacency[2], dev)
        # patch capacity: template verts within range*spacing of a CP
        nt = self.template.nvertices
        frac = (cfg.cprange * control.calculate_MaxVD())**2 / (4 * RAD**2)
        self.pmax = int(min(nt, max(64, 2.5 * frac * nt)))

        labels = np.asarray(self.sampling.samples, np.float32)
        cp_search = build_tables(control.coords, control.faces,
                                 control.adjacency[2], dev)
        mask_w = (self._f32(self.mask).abs()
                  if self.mask is not None else None)
        self.level_statics = GF.GroupLevelStatics(
            labels=self._f32(labels), centre=self.centre,
            orig_cp=self._f32(control.coords),
            cp_faces=torch.as_tensor(trip.astype(np.int64)).to(dev),
            tmpl_coords=self._f32(self.template.coords),
            mask_w=mask_w, cp_search=cp_search,
            mu=cfg.shearmod, kappa=cfg.bulkmod, k_exp=cfg.k_exponent,
            rexp=cfg.regexp, reglambda=cfg.reglambda[level],
            subcorr=0.1 * S,             # DiscreteGroupCostFunction.h:45
            simval=cfg.simval[level], percentile=cfg.percentile,
            pmax=self.pmax, cprange=cfg.cprange, fixnan=cfg.fixnan)

        dg0 = self.sph_orig
        dg_tri_idx = dg0.adjacency[2]
        dg_tables = build_tables(dg0.coords, dg0.faces, dg_tri_idx, dev)
        dg_topology = (dg_tables.faces,
                       torch.as_tensor(dg_tri_idx.astype(np.int64)).to(dev),
                       dg_tables.ring_faces, dg_tables.ring_verts,
                       self.template_tables,
                       self._f32(self.template.vertex_area()))
        cap = rsp._adaptive_cap(dg0.nvertices, nt)
        self._maps_fn = GF.make_maps_fn(self.level_statics, dg_topology, cap)
        self._apply_fn = GF.make_apply_fn(self.level_statics, S, control, dg0,
                                          self.comm)
        self._partner_fn = GF.make_partner_fn(self.level_statics, S,
                                              self.comm)
        exchange = self.maps_exchange
        if exchange == "auto":
            D = self.feat.data[0].shape[0]
            exchange = choose_maps_exchange(S * len(labels) * D * nt * 4,
                                            dev, self.comm)
        self._maps_exchange_used = exchange
        self._fusion_fn = self._make_fusion_fn()
        if self.verbose and self.comm.rank == 0:
            print(f"   S={S} K={K} labels={len(labels)} pmax={self.pmax} "
                  f"device={dev} ranks={self.comm.world} "
                  f"maps_exchange={exchange}")

    def _make_fusion_fn(self):
        return GF.make_fusion_fn(self.level_statics, len(self.meshes),
                                 random_starts=self.fusion_random_starts,
                                 comm=self.comm,
                                 maps_exchange=self._maps_exchange_used)

    # ---- outer loop ------------------------------------------------------
    def _evaluate(self, level: int):
        """Outer discrete-optimisation loop (group run_discrete_opt,
        group_mesh_registration.cpp:70-118). Every rank runs it with its own
        subjects' state; the loop's decisions (pmax regrow, early stop) read
        values that are equal on every rank, so all ranks make the same
        collective calls."""
        cfg = self.cfg
        dev = self.device
        S = len(self.meshes)
        K = self.control.nvertices
        energy = 0.0

        # this rank's subjects' device state, resident across iterations
        # (the apply stage runs on the device too)
        ids = self._owned_ids()
        dg_coords = self._f32(np.stack([self.sph_reg[s].coords for s in ids]))
        dg_data = self._f32(np.stack(
            [self.feat.data[self._feat_row[s]] for s in ids]))
        cp = self._f32(np.stack([self.cp_grids[s].coords for s in ids]))
        spac = self._f32(np.stack(
            [self.cp_grids[s].max_vertex_distances() for s in ids]))

        def sync_host_meshes():
            for arr, grids in ((dg_coords, self.sph_reg),
                               (cp, self.cp_grids)):
                data = arr.cpu().numpy().astype(np.float64)
                for i, s in enumerate(ids):
                    grids[s].coords = data[i]

        for it in range(cfg.iters[level]):
            with trace.span("setup") as setup:
                if self.debug:
                    # per-iteration mesh dumps (DiscreteModel.cpp:234-240
                    # analog)
                    sync_host_meshes()
                    for s in ids:
                        self.sph_reg[s].save(self._out(
                            f"SOURCE-{s}-{self.level}-{it}.surf.gii"))
                        self.cp_grids[s].save(self._out(
                            f"CPgrid-{s}-{self.level}-{it}.surf.gii"))

                # label-deformed template maps of this rank's subjects (no
                # collective)
                with trace.span("group.maps"):
                    maps = self._maps_fn(dg_coords, dg_data)
                # cross-subject correspondences (all-gathered), then the
                # incidence + colouring of this iteration's pair structure
                with trace.span("group.iter_tables"):
                    partner = self._partner_fn(cp)
                    tables = GF.build_iteration_tables(
                        trace.read(partner).numpy(), self.cp_triplets, S, K,
                        dev)

            with trace.span("opt") as opt:
                labeling0 = torch.zeros(S * K, dtype=torch.int64, device=dev)
                labeling, energy_dev, need_dev = self._fusion_fn(
                    maps, cp, spac, labeling0, partner, tables)
                patch_need = int(trace.read(need_dev))
                patch_overflow = max(0, patch_need - self.pmax)
                # the reference's patches are uncapped
                # (DiscreteGroupModel.cpp:88-121): on truncation, pre-size
                # pmax from the measured max in-range count (+10% headroom,
                # rounded to 16) and redo this iteration. patch_need is
                # MAX-combined over the ranks, so all ranks regrow together
                nt = self.template.nvertices
                regrows = 0
                while patch_overflow and self.pmax < nt:
                    with trace.span("group.regrow"):
                        trace.count("pmax_before", self.pmax)
                        self.pmax = int(min(nt, max(
                            self.pmax + 16,
                            -(-int(patch_need * 1.1) // 16) * 16)))
                        trace.count("pmax_after", self.pmax)
                        if self.comm.rank == 0:
                            print(f"groupwise level {self.level} iter {it}: "
                                  f"patches need {patch_need} slots; "
                                  f"growing pmax to {self.pmax}")
                        self.level_statics = self.level_statics._replace(
                            pmax=self.pmax)
                        self._fusion_fn = self._make_fusion_fn()
                        labeling, energy_dev, need_dev = self._fusion_fn(
                            maps, cp, spac, labeling0, partner, tables)
                        patch_need = int(trace.read(need_dev))
                        patch_overflow = max(0, patch_need - self.pmax)
                    regrows += 1
                trace.count("regrows", regrows)
                newenergy = float(trace.read(energy_dev))
            self.energy_log.append((self.level, it, newenergy))
            changed = float(trace.read((labeling != 0).float().mean()))
            if trace.active():
                # every rank's own stage seconds and pair-block batches
                secs = self.comm.all_gather(torch.tensor(
                    [[setup.wall_s, opt.wall_s,
                      self._fusion_fn.pair_chunks]],
                    dtype=torch.float64, device=dev))
                trace.event("iter", level=self.level, iter=it,
                            energy=newenergy, changed=changed,
                            patch_overflow=patch_overflow,
                            pmax=self.pmax, devices=self.comm.world,
                            maps_exchange=self._maps_exchange_used,
                            colors=len(tables.groups),
                            setup_s=round(setup.wall_s, 4),
                            opt_s=round(opt.wall_s, 4),
                            setup_s_by_rank=[round(float(x), 4)
                                             for x in secs[:, 0]],
                            opt_s_by_rank=[round(float(x), 4)
                                           for x in secs[:, 1]],
                            pair_chunk_blocks=(
                                self._fusion_fn.pair_chunk_blocks),
                            pair_chunks_by_rank=[int(x)
                                                 for x in secs[:, 2]])
            if self.verbose and self.comm.rank == 0:
                times = (f"  [setup {setup.wall_s:.2f}s opt "
                         f"{opt.wall_s:.2f}s]" if trace.active() else "")
                print(f"  iter {it}: energy {newenergy:.4f} "
                      f"({changed:.0%} nodes moved){times}")

            if it > 1 and (energy - newenergy < newenergy * 0.01):
                break

            # apply labeling: unfold + warp on the device
            # (group_mesh_registration.cpp:104-115)
            with trace.span("warp") as warp:
                dg_coords, cp, spac = self._apply_fn(dg_coords, cp, labeling)
            energy = newenergy
            trace.event("warp", level=self.level, iter=it,
                        warp_s=round(warp.wall_s, 4))

        sync_host_meshes()

    # ---- outputs ---------------------------------------------------------
    def _out(self, name: str) -> str:
        d = os.path.dirname(self.outdir)
        if d:
            os.makedirs(d, exist_ok=True)
        return self.outdir + name

    def _write_outputs(self):
        # each rank writes only the subjects it owns (the reference's
        # per-host SLURM task split, group_mesh_registration.cpp:120-133)
        S = len(self.meshes)
        self.transformed_data = [None] * S
        for s in self._owned_ids():
            mesh = self.meshes[s]
            warped = rsp.sphere_project_warp(mesh, self.sph_orig,
                                             self.sph_reg[s], self.device)
            warped.save(self._out(f"sphere-{s}.reg" + self.surf_format))
            carrier = Mesh(coords=warped.coords, faces=warped.faces,
                           data=self.datasets[s])
            res, _ = rsp.metric_resample(carrier, self.template,
                                         device=self.device)
            res.save(self._out(f"transformed_and_reprojected-{s}"
                               + self.data_format))
            self.transformed_data[s] = res.data
