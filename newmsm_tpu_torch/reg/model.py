"""Discrete MRF model state and per-iteration setup for pairwise
registration (NonLinearSRegDiscreteModel, DiscreteModel.cpp).

Port of newmsm_tpu/reg/model.py for the HOCR / triplet-strain path. Holds
the per-level tables (LevelTables, fusion tables, sampling grid) on one
device and produces each iteration's inputs: labels, rotations, patches,
cost-function weighting.

Not carried over from the JAX package: label-shape bucketing (it only lets
XLA reuse one compiled program across label counts) and the blocked-gather
budgets (ops/blocked.py suits the TPU's gather rate; the exact path runs).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from newmsm_tpu.core.mesh import Mesh
from newmsm_tpu.reg.sampling_grid import build_sampling_grid, rescale_labels

from ..ops import resample as rsp
from ..ops.nearest import build_tables
from . import costs as C
from .optimise.fusion import FusionTables, bits, build_fusion_tables



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
    rescale_labels: bool = False
    multivariate: bool = False
    fixnan: bool = False


LABELDIST = 0.5              # _labeldist (DiscreteModel.h:167)


class PairwiseModel:
    """Per-level discrete model: device tensors, host orchestration."""

    def __init__(self, cfg: ModelConfig, cp_grid: Mesh, source: Mesh,
                 target: Mesh, feat_src: np.ndarray, feat_ref: np.ndarray,
                 device="cpu"):
        if cfg.regmode not in (2, 3):
            raise NotImplementedError(
                f"regoption {cfg.regmode} is not ported yet; the port runs "
                "the triplet-strain regulariser (regoption 2/3), see "
                "ROADMAP.md queue 1")
        self.cfg = cfg
        self.device = torch.device(device)
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
        self.tables = C.LevelTables(
            target_tables=build_tables(target.coords, target.faces,
                                       target.adjacency[2], dev),
            target_data=torch.as_tensor(feat_ref, dtype=torch.float32).to(dev),
            source_data=torch.as_tensor(feat_src, dtype=torch.float32).to(dev),
            orig_cp=torch.as_tensor(cp_grid.coords, dtype=torch.float32).to(dev),
            triplets=torch.as_tensor(trip.astype(np.int64)).to(dev),
            maxsep=torch.as_tensor(self.maxsep, dtype=torch.float32).to(dev),
        )
        self.fusion_tables: FusionTables = build_fusion_tables(trip, K, dev)

        # patch capacity: exact level-init in-range count + 25% deformation
        # margin, rounded to 16
        cnt = C.max_inrange_count(
            self.cp_grid.coords, source.coords,
            cfg.cprange * self.tables.maxsep.cpu().numpy())
        self.pmax = int(min(source.nvertices,
                            max(32, -(-int(cnt * 1.25) // 16) * 16)))
        self.iter = 1
        self.scale = 1.0
        self.labeling = np.zeros(K, np.int64)
        self._warned_overflow = False

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
            limits.cpu().numpy())
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
        self.iter += 1
        return s

    def unary(self, s) -> torch.Tensor:
        cfg = self.cfg
        return C.unary_costs(
            s["cp"], s["rl"], s["src"], s["patch_idx"], s["patch_mask"],
            self.tables.target_tables, self.tables.source_data,
            self.tables.target_data, s["cfweights"], s["abs_weights"],
            cfg.simval, cfg.percentile,
            mode="multivariate" if cfg.multivariate else "univariate")

    def triplet_combo_fn(self, s):
        """Triplet strain costs for label-index arrays, with the binary-move
        specialisation `binary_fast` attached (see fusion.binary_move_tables)."""
        cfg = self.cfg
        rl, cp = s["rl"], s["cp"]
        t = self.tables.triplets
        args = (cfg.reglambda, cfg.mu, cfg.kappa, cfg.k_exp, cfg.rexp)

        def regulariser(la, lb, lc):
            return C.triplet_combo_costs(rl, cp, self.tables, la, lb, lc,
                                         *args, fixnan=cfg.fixnan)

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

    def apply_labeling(self, labeling: np.ndarray, s) -> None:
        """CP_k <- ROT_k @ label_{l_k} (applyLabeling, DiscreteModel.cpp:264)."""
        rl = s["rl"].cpu().numpy()
        self.cp_grid.coords = rl[np.arange(rl.shape[0]),
                                 labeling].astype(np.float64)
