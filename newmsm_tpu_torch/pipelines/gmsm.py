"""gMSM pipeline: groupwise registration + dedrifting + group statistics.

Python replacement of the reference's bash/SLURM/wb_command orchestration
(gMSM_scripts/run_gMSM.sh): run groupwise registration for one group,
remove the common drift (the average warp) from every subject, resample
data to the template, and compute mean/stdev maps plus distortion and
similarity statistics — all in-process, no Workbench dependency. Every entry
point takes a `device` (None means cuda).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .. import RAD, resolve_device
from ..core.mesh import Mesh
from ..ops import resample as rsp
from ..ops.unfold import unfold
from ..reg.config import RegConfig, parse_config
from ..reg.group import GroupMeshRegistration
from ..eval import metrics


@dataclass
class GMSMResult:
    dedrifted_spheres: List[Mesh]
    resampled_data: List[np.ndarray]   # per subject, (D, N_template)
    mean_map: np.ndarray
    stdev_map: np.ndarray
    stats: dict = field(default_factory=dict)


def dedrift(warped_spheres: List[Mesh], original: Mesh,
            device=None) -> List[Mesh]:
    """Remove the group-average warp (run_gMSM.sh:70-117): average the warped
    spheres (surface-average), then project each subject's warp through the
    inverse of the average (surface-sphere-project-unproject)."""
    device = resolve_device(device)
    avg = original.copy()
    coords = np.mean([m.coords for m in warped_spheres], axis=0)
    norms = np.linalg.norm(coords, axis=1, keepdims=True)
    avg.coords = coords / np.maximum(norms, 1e-12) * RAD
    avg.recentre()
    avg.true_rescale(RAD)

    out = []
    for m in warped_spheres:
        # compose subject warp with the inverse average: express the warped
        # sphere in the average-warp frame, re-evaluate on the original grid
        ded = rsp.sphere_project_warp(m, avg, original, device)
        out.append(unfold(ded, device=device))
    return out


def run_gmsm(meshes: List[Mesh], datasets: List[np.ndarray], template: Mesh,
             config: RegConfig | str | None, outdir: str = "",
             verbose: bool = False, dedrift_warps: bool = True,
             device=None) -> GMSMResult:
    """One full gMSM group run (run_gMSM.sh)."""
    device = resolve_device(device)
    gmr = GroupMeshRegistration(device=device)
    gmr.set_inputs(meshes)
    gmr.set_data_list(datasets)
    gmr.set_template(template)
    gmr.verbose = verbose
    tmp_ctx = None
    if not outdir:
        # never write intermediates into the caller's CWD; cleaned up below
        import tempfile
        tmp_ctx = tempfile.TemporaryDirectory(prefix="gmsm_")
        outdir_run = tmp_ctx.name + "/"
    else:
        outdir_run = outdir
    gmr.outdir = outdir_run
    try:
        gmr.run_multiresolutions(config)
    finally:
        if tmp_ctx is not None:
            tmp_ctx.cleanup()

    original = gmr.sph_orig
    warped = gmr.sph_reg
    # lift the data-grid warps onto the subjects' native spheres
    native_warped = [rsp.sphere_project_warp(meshes[s], original, warped[s],
                                             device)
                     for s in range(len(meshes))]
    if dedrift_warps:
        native_warped = dedrift(native_warped, meshes[0], device)

    resampled = []
    for s, m in enumerate(native_warped):
        carrier = Mesh(coords=m.coords, faces=m.faces,
                       data=np.atleast_2d(datasets[s]))
        res, _ = rsp.metric_resample(carrier, template, device=device)
        resampled.append(res.data)

    stack = np.stack(resampled)                      # (S,D,Nt)
    mean_map = stack.mean(axis=0)
    stdev_map = stack.std(axis=0)

    stats = {
        "cc": metrics.mean_pairwise_cc([r[0] for r in resampled]),
        "dice": metrics.mean_pairwise_dice([r[0] for r in resampled]),
    }
    per_subj = []
    for s, m in enumerate(native_warped):
        areal, shape = metrics.distortion_maps(meshes[s], m)
        per_subj.append(metrics.distortion_stats(areal, shape))
    for key in per_subj[0]:
        stats[key] = float(np.mean([d[key] for d in per_subj]))

    if outdir:
        d = os.path.dirname(outdir)
        if d:
            os.makedirs(d, exist_ok=True)
        for s, m in enumerate(native_warped):
            m.save(outdir + f"sphere-{s}.dedrift.reg.surf.gii")
        Mesh(coords=template.coords, faces=template.faces,
             data=mean_map).save(outdir + "mean.func.gii")
        Mesh(coords=template.coords, faces=template.faces,
             data=stdev_map).save(outdir + "stdev.func.gii")

    return GMSMResult(dedrifted_spheres=native_warped,
                      resampled_data=resampled,
                      mean_map=mean_map, stdev_map=stdev_map, stats=stats)


def run_cgmsm(groups: dict, tree: List[tuple], datasets: dict, template: Mesh,
              config: RegConfig | str | None, verbose: bool = False,
              dedrift_warps: bool = True, device=None) -> dict:
    """Hierarchical cgMSM (run_cgMSM_ver_gw_iter.sh): walk a binary tree of
    groups; at each internal node, groupwise-register the two children's MEAN
    feature maps, dedrift the node's warps (the script's dedrifting phase,
    run_cgMSM_ver_gw_iter.sh:68-107), then project all member subjects
    through the node's (dedrifted) warp.

    groups: {group_id: [subject ids]}; tree: [(left, right, root), ...] in
    evaluation order; datasets: {subject id: (mesh, (D,N) data)}.
    Returns {group_id: {"warp": per-subject warped meshes, "mean": map}}.
    """
    device = resolve_device(device)
    state: dict = {}
    for gid, members in groups.items():
        maps, meshes = [], []
        for sid in members:
            mesh, data = datasets[sid]
            carrier = Mesh(coords=mesh.coords, faces=mesh.faces,
                           data=np.atleast_2d(data))
            res, _ = rsp.metric_resample(carrier, template, device=device)
            maps.append(res.data)
            meshes.append(mesh)
        state[gid] = {
            "members": list(members),
            "meshes": {s: datasets[s][0].copy() for s in members},
            "mean": np.mean(maps, axis=0),
        }

    for left, right, root in tree:
        lm = state[left]
        rm = state[right]
        pair = GroupMeshRegistration(device=device)
        tm = template.copy()
        pair.set_inputs([tm.copy(), tm.copy()])
        pair.set_data_list([lm["mean"], rm["mean"]])
        pair.set_template(template)
        pair.verbose = verbose
        pair.run_multiresolutions(config)

        warped = pair.sph_reg                       # 2 data-grid warps
        original = pair.sph_orig
        if dedrift_warps:
            warped = dedrift(warped, original, device)
        merged_members = lm["members"] + rm["members"]
        merged_meshes = {}
        maps = []
        for side, groupstate in ((0, lm), (1, rm)):
            side_warp_lo = warped[side]
            for sid in groupstate["members"]:
                mesh = groupstate["meshes"][sid]
                w = rsp.sphere_project_warp(mesh, original, side_warp_lo,
                                            device)
                merged_meshes[sid] = unfold(w, device=device)
                carrier = Mesh(coords=merged_meshes[sid].coords,
                               faces=merged_meshes[sid].faces,
                               data=np.atleast_2d(datasets[sid][1]))
                res, _ = rsp.metric_resample(carrier, template,
                                             device=device)
                maps.append(res.data)
        state[root] = {
            "members": merged_members,
            "meshes": merged_meshes,
            "mean": np.mean(maps, axis=0),
        }
    return state
