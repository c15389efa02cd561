"""Discrete MRF model state and per-iteration setup for pairwise
registration (NonLinearSRegDiscreteModel, DiscreteModel.cpp).

Port of newmsm_tpu/reg/model.py. Holds the per-level tables (LevelTables,
fusion tables, face colour groups, sampling grid, anatomical tables) on one
device and produces each iteration's inputs: labels, rotations, patches,
face patches, cost-function weighting.

Not carried over from the JAX package: label-shape bucketing (it only lets
XLA reuse one compiled program across label counts) and the blocked-gather
budgets (ops/blocked.py suits the TPU's gather rate; the exact path runs).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device, trace
from ..core.mesh import Mesh
from ..ops import resample as rsp
from ..ops.nearest import build_tables
from . import costs as C
from .optimise.coloring import color_groups, face_coloring
from .optimise.fusion import FusionTables, bits, build_fusion_tables
from .sampling_grid import build_sampling_grid, rescale_labels


@dataclass
class ModelConfig:
    simval: int = 2
    reglambda: float = 0.0
    sg_res: int = 4
    regmode: int = 3
    mu: float = 0.4          # --shearmod
    kappa: float = 1.6       # --bulkmod
    k_exp: float = 2.0       # --k_exponent
    rexp: float = 2.0        # --regexp
    cprange: float = 1.0
    percentile: float = 0.75
    triclique: bool = False
    patchwise: bool = False
    rescale_labels: bool = False
    multivariate: bool = False
    fixnan: bool = False


LABELDIST = 0.5              # _labeldist (DiscreteModel.h:167)


class PairwiseModel:
    """Per-level discrete model: device tensors, host orchestration
    (`device` None means cuda)."""

    def __init__(self, cfg: ModelConfig, cp_grid: Mesh, source: Mesh,
                 target: Mesh, feat_src: np.ndarray, feat_ref: np.ndarray,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        dev = self.device
        self.cp_grid = cp_grid.copy()        # current CP grid (moves)
        self.orig_cp = cp_grid.copy()        # level-start grid
        self.source = source.copy()          # warped source datagrid (moves)
        self.target = target
        K = cp_grid.nvertices

        # per-CP max spacing, level init (DiscreteModel.cpp:72-89)
        self.maxsep = cp_grid.max_vertex_distances()
        self.mvd_max = cp_grid.calculate_MaxVD()
        self.max_label_dist = LABELDIST * self.mvd_max
        self.sampling = build_sampling_grid(cfg.sg_res, self.max_label_dist)
        self.centre = torch.as_tensor(self.sampling.centre,
                                      dtype=torch.float32).to(dev)

        # triplets: sorted CP face ids (DiscreteModel.cpp:293-308)
        trip = np.sort(cp_grid.faces.astype(np.int32), axis=1)
        self.triplets_np = trip
        # pairs: CP edges, sorted (DiscreteModel.cpp:271-291)
        f = cp_grid.faces.astype(np.int64)
        edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]],
                                        f[:, [0, 2]]]), axis=1)
        self.pairs_np = np.unique(edges, axis=0).astype(np.int32)

        def ids(a):
            return torch.as_tensor(np.asarray(a).astype(np.int64)).to(dev)

        self.tables = C.LevelTables(
            target_tables=build_tables(target.coords, target.faces,
                                       target.adjacency[2], dev),
            target_data=torch.as_tensor(feat_ref, dtype=torch.float32).to(dev),
            source_data=torch.as_tensor(feat_src, dtype=torch.float32).to(dev),
            orig_cp=torch.as_tensor(cp_grid.coords, dtype=torch.float32).to(dev),
            triplets=ids(trip),
            pairs=ids(self.pairs_np),
            cp_faces=ids(cp_grid.faces),
            cp_tri_idx=ids(cp_grid.adjacency[2]),
            maxsep=torch.as_tensor(self.maxsep, dtype=torch.float32).to(dev),
            mvd_max=torch.as_tensor(self.mvd_max, dtype=torch.float32).to(dev),
        )

        self.pairwise_mode = cfg.regmode == 1
        self.fusion_tables: FusionTables = build_fusion_tables(
            trip if not self.pairwise_mode else np.zeros((0, 3), np.int32),
            K, dev, pairs=self.pairs_np if self.pairwise_mode else None)
        # conflict-free triplet groups for the MCMC sweep
        fgroups, fmask = color_groups(face_coloring(trip, K))
        self.face_groups = ids(fgroups)              # (C,G), -1 padded
        self.face_group_mask = torch.from_numpy(fmask).to(dev)

        # patch capacity: exact level-init in-range count + 25% deformation
        # margin, rounded to 16
        cnt = C.max_inrange_count(
            self.cp_grid.coords, source.coords,
            cfg.cprange * self.maxsep, device=dev)
        self.pmax = int(min(source.nvertices,
                            max(32, -(-int(cnt * 1.25) // 16) * 16)))
        self.iter = 1
        self.scale = 1.0
        self.labeling = np.zeros(K, np.int64)
        self._warned_overflow = False
        self._warned_face_overflow = False
        self.anat: "C.AnatTables | None" = None   # set by driver for regmode 5
        # masked-in face-patch slots of this iteration (traced runs only)
        self.face_valid = 0
        if cfg.triclique:
            density = source.nvertices / trip.shape[0]
            self.fmax = int(min(source.nvertices, max(16, 6 * density)))
            trace.event("triclique.shape", D=int(feat_ref.shape[0]),
                        res=int(self.tables.target_tables.pristine_res),
                        fmax=self.fmax, T=int(trip.shape[0]))
        else:
            self.fmax = 0

    # -- per-iteration pieces ------------------------------------------------

    def current_labels(self) -> np.ndarray:
        """Label set for this iteration (DiscreteModel.cpp:242-248):
        barycentres on odd iters, vertices on even; or rescaled grid."""
        if self.cfg.rescale_labels:
            if self.scale >= 0.25:
                labels = rescale_labels(self.sampling, self.sampling.samples,
                                        self.scale)
            else:
                self.scale = 1.0
                labels = self.sampling.samples
            self.scale *= 0.8
            return labels
        return (self.sampling.samples if self.iter % 2 == 0
                else self.sampling.barycentres)

    def setup_iteration(self, cfweights: np.ndarray):
        """Device inputs for one outer iteration (setupCostFunction,
        DiscreteModel.cpp:216-262)."""
        cfg = self.cfg
        dev = self.device
        labels = self.current_labels()
        self.num_labels = len(labels)
        self.labels_np = labels
        K = self.cp_grid.nvertices
        self.labeling = np.zeros(K, np.int64)

        cp = torch.as_tensor(self.cp_grid.coords, dtype=torch.float32).to(dev)
        src = torch.as_tensor(self.source.coords, dtype=torch.float32).to(dev)
        lbl = torch.as_tensor(labels, dtype=torch.float32).to(dev)
        rots, rl = C.rotated_label_positions(cp, lbl, self.centre)

        limits = cfg.cprange * self.tables.maxsep
        ball_np = C.patch_candidate_ball(
            cp.cpu().numpy(), src.cpu().numpy(), self.source.faces,
            limits.cpu().numpy(), device=dev)
        ball = None if ball_np is None else torch.as_tensor(
            ball_np.astype(np.int64)).to(dev)

        def patches():
            return C.build_patches(cp, src, self.tables.maxsep, cfg.cprange,
                                   self.pmax, ball)

        patch_idx, patch_mask, overflow = patches()
        # the reference's patches are uncapped vectors
        # (DiscreteCostFunction.cpp:334-351): on overflow, grow pmax and
        # rebuild rather than silently dropping in-range vertices
        for _ in range(6):
            if not bool(overflow.any()):
                break
            self.pmax = min(src.shape[0], max(self.pmax + 16,
                                              -(-int(self.pmax * 1.5) // 16) * 16))
            if not self._warned_overflow:
                print(f"patch capacity overflow: growing pmax to {self.pmax}")
                self._warned_overflow = True
            patch_idx, patch_mask, overflow = patches()

        # AbsoluteWeights: max-over-dims of cfweights resampled to CP grid
        # (resample_weights, DiscreteCostFunction.cpp:303-323)
        absw_src = cfweights.max(axis=0)
        if absw_src.min() == absw_src.max():
            absw = np.full(K, absw_src.flat[0])
        else:
            carrier = Mesh(coords=self.source.coords, faces=self.source.faces,
                           data=absw_src[None, :])
            absw = rsp.metric_resample(carrier, self.cp_grid,
                                       device=dev)[0].data[0]
        s = dict(
            cp=cp, src=src, labels=lbl, rots=rots, rl=rl,
            patch_idx=patch_idx, patch_mask=patch_mask,
            cfweights=torch.as_tensor(cfweights, dtype=torch.float32).to(dev),
            abs_weights=torch.as_tensor(absw, dtype=torch.float32).to(dev),
        )
        if cfg.triclique:
            # per-CP-face source patches (rebuilt each iteration: the CP
            # grid moves; HO get_source_data, DiscreteCostFunction.cpp:468)
            cp_search = build_tables(self.cp_grid.coords, self.cp_grid.faces,
                                     self.cp_grid.adjacency[2], dev)
            fidx, fmask, foverflow = C.build_face_patches(src, cp_search,
                                                          self.fmax)
            if not self._warned_face_overflow and bool(foverflow.any()):
                print("warning: face patch capacity overflow; increase fmax")
                self._warned_face_overflow = True
            s["face_idx"], s["face_mask"] = fidx, fmask
            if trace.active():
                self.face_valid = int(trace.read(fmask.sum()))
        self.iter += 1
        return s

    def unary(self, s) -> torch.Tensor:
        cfg = self.cfg
        if cfg.triclique:
            # triclique mode has no unary data term (DiscreteCostFunction.h:220)
            return torch.zeros((s["cp"].shape[0], s["labels"].shape[0]),
                               dtype=torch.float32, device=self.device)
        mode = ("patchwise" if cfg.patchwise else
                "multivariate" if cfg.multivariate else "univariate")
        return C.unary_costs(
            s["cp"], s["rl"], s["src"], s["patch_idx"], s["patch_mask"],
            self.tables.target_tables, self.tables.source_data,
            self.tables.target_data, s["cfweights"], s["abs_weights"],
            cfg.simval, cfg.percentile, mode=mode)

    def triplet_combo_fn(self, s):
        """Triplet costs for label-index arrays (T,C): the spherical strain
        regulariser (regoption 2/3) or the anatomical one (regoption 5),
        plus the triclique likelihood under --triclique. The plain strain
        regulariser carries the binary-move specialisation `binary_fast`
        (see fusion.binary_move_tables); the others take the generic (T,8)
        label path."""
        cfg = self.cfg
        rl, cp = s["rl"], s["cp"]
        t = self.tables.triplets
        args = (cfg.reglambda, cfg.mu, cfg.kappa, cfg.k_exp, cfg.rexp)

        def regulariser(la, lb, lc):
            if cfg.regmode in (4, 5) and self.anat is not None:
                return C.anatomical_triplet_costs(
                    cp, rl, self.tables, self.anat, la, lb, lc, *args,
                    fixnan=cfg.fixnan)
            return C.triplet_combo_costs(rl, cp, self.tables, la, lb, lc,
                                         *args, fixnan=cfg.fixnan)

        if cfg.triclique:
            def fn(la, lb, lc):
                with trace.span("triclique"):
                    lik = C.triclique_likelihood(
                        cp, rl, self.tables, s["face_idx"], s["face_mask"],
                        s["src"], s["abs_weights"], s["cfweights"], la, lb,
                        lc, cfg.simval, cfg.percentile,
                        multivariate=cfg.multivariate and not cfg.patchwise)
                    # what K1 is sent, and the slots that carry data
                    trace.count("queries", la.numel() * self.fmax)
                    trace.count("valid", la.shape[1] * self.face_valid)
                return lik + regulariser(la, lb, lc)
            return fn
        if cfg.regmode not in (2, 3):
            return regulariser

        def binary_fast(cur3, alpha):
            """(T,8) strain tables from 2 gathered positions per corner."""
            bit = bits(rl.device)
            combos = []
            for corner in range(3):
                keep = rl[t[:, corner], cur3[:, corner]][:, None]   # (T,1,3)
                switch = rl[t[:, corner], alpha][:, None]
                combos.append(torch.where(bit[None, :, corner, None] == 1,
                                          switch, keep))             # (T,8,3)
            return C.triplet_costs_from_positions(
                *combos, cp, self.tables, *args, fixnan=cfg.fixnan)

        regulariser.binary_fast = binary_fast
        return regulariser

    def pair_combo_fn(self, s):
        """Pair costs for label-index arrays (Pr,C), read from the
        (Pr,L,L) rotation-difference volume (kept as `fn.volume`)."""
        cfg = self.cfg
        vol = C.pairwise_cost_volume(s["rl"], s["cp"], self.tables,
                                     cfg.reglambda, cfg.rexp)
        pr = torch.arange(vol.shape[0], device=vol.device)[:, None]

        def fn(pa, pb):
            return vol[pr, pa, pb]

        fn.volume = vol
        return fn

    def apply_labeling(self, labeling: np.ndarray, s) -> None:
        """CP_k <- ROT_k @ label_{l_k} (applyLabeling, DiscreteModel.cpp:264)."""
        rl = s["rl"].cpu().numpy()
        self.cp_grid.coords = rl[np.arange(rl.shape[0]),
                                 labeling].astype(np.float64)
