"""gMSM pipeline: groupwise registration + dedrifting + group statistics.

Python replacement of the reference's bash/SLURM/wb_command orchestration
(gMSM_scripts/run_gMSM.sh): run groupwise registration for one group,
remove the common drift (the average warp) from every subject, resample
data to the template, and compute mean/stdev maps plus distortion and
similarity statistics — all in-process, no Workbench dependency. Every entry
point takes a `device` (None means cuda) and a torch.distributed `group`
(None: this process alone): under torchrun or multihost.run_local_ranks,
the ranks share the work and each gets the one-rank result.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .. import RAD, resolve_device, trace
from ..core.mesh import Mesh
from ..ops import resample as rsp
from ..ops.unfold import unfold
from ..reg.config import RegConfig, parse_config
from ..parallel import multihost as mh
from ..reg.group import GroupMeshRegistration
from ..eval import metrics


@dataclass
class GMSMResult:
    dedrifted_spheres: List[Mesh]
    resampled_data: List[np.ndarray]   # per subject, (D, N_template)
    mean_map: np.ndarray
    stdev_map: np.ndarray
    stats: dict = field(default_factory=dict)
    energies: list = field(default_factory=list)  # (level, iter, energy)


def _spread(comm: mh.SubjectComm, n: int, fn, width: int = 1) -> list:
    """fn(i) -> `width` host arrays, for i in range(n): each rank computes
    its share (multihost.share) and every rank gets all n tuples in item
    order. Each item is computed alone, so the rank count changes no bit."""
    mine = [fn(i) for i in mh.share(n, comm)]
    if comm.world == 1:
        return mine
    flat = comm.all_gather_arrays([a for item in mine for a in item])
    return [tuple(flat[i * width:(i + 1) * width]) for i in range(n)]


def _like(mesh: Mesh, coords: np.ndarray) -> Mesh:
    """A mesh of `mesh`'s faces and data at new coordinates: what
    sphere_project_warp and unfold return for it."""
    return Mesh(coords=coords, faces=mesh.faces,
                data=None if mesh.data is None else mesh.data.copy())


def dedrift(warped_spheres: List[Mesh], original: Mesh,
            device=None, group=None) -> List[Mesh]:
    """Remove the group-average warp (run_gMSM.sh:70-117): average the warped
    spheres (surface-average), then project each subject's warp through the
    inverse of the average (surface-sphere-project-unproject). Every rank
    of `group` (None: this process alone) passes all the spheres and gets
    all the results; the per-subject projections are split over the
    ranks."""
    device = resolve_device(device)
    comm = mh.SubjectComm(group)
    avg = original.copy()
    coords = np.mean([m.coords for m in warped_spheres], axis=0)
    norms = np.linalg.norm(coords, axis=1, keepdims=True)
    avg.coords = coords / np.maximum(norms, 1e-12) * RAD
    avg.recentre()
    avg.true_rescale(RAD)

    def one(s):
        # compose subject warp with the inverse average: express the warped
        # sphere in the average-warp frame, re-evaluate on the original grid
        ded = rsp.sphere_project_warp(warped_spheres[s], avg, original, device)
        return (unfold(ded, device=device).coords,)
    return [_like(m, c) for m, (c,) in zip(
        warped_spheres, _spread(comm, len(warped_spheres), one))]


def run_gmsm(meshes: List[Mesh], datasets: List[np.ndarray], template: Mesh,
             config: RegConfig | str | None, outdir: str = "",
             verbose: bool = False, dedrift_warps: bool = True,
             device=None, group=None,
             metrics_path: Optional[str] = None) -> GMSMResult:
    """One full gMSM group run (run_gMSM.sh), over the ranks of `group` (a
    torch.distributed process group whose size divides the subject count;
    None: this process alone, whether or not a process group is up). Every
    rank passes every subject and gets the whole result, bitwise that of
    one rank: the registration shards the subjects (reg/group.py), the
    lift, dedrift and resamples split them over the ranks and all-gather
    them in subject order, and the group statistics are the same host
    computation on every rank. Rank 0 alone writes the dedrifted spheres
    and the mean and stdev maps (each rank writes its own subjects'
    registration outputs) and `metrics_path` (the driver's JSONL
    events)."""
    device = resolve_device(device)
    gmr = GroupMeshRegistration(device=device, group=group)
    comm = gmr.comm
    gmr.set_inputs(meshes)
    gmr.set_data_list(datasets)
    gmr.set_template(template)
    gmr.verbose = verbose
    gmr.metrics_path = metrics_path
    tmp_ctx = None
    if not outdir:
        # never write intermediates into the caller's CWD; cleaned up below
        # (a directory of this process's own, so one per rank)
        import tempfile
        tmp_ctx = tempfile.TemporaryDirectory(prefix="gmsm_")
        outdir_run = tmp_ctx.name + "/"
    else:
        outdir_run = outdir
    gmr.outdir = outdir_run
    # rank 0 writes the metrics; the registration's and the
    # post-processing's spans are one unit
    with trace.run(metrics_path if comm.rank == 0 else None, device,
                   on=bool(metrics_path)):
        try:
            gmr.run_multiresolutions(config)
        finally:
            if tmp_ctx is not None:
                tmp_ctx.cleanup()

        S = len(meshes)
        original = gmr.sph_orig
        # lift the data-grid warps onto the subjects' native spheres
        with trace.span("gmsm.lift"):
            warped = gmr.registered_spheres()
            native_warped = [_like(meshes[s], c) for s, (c,) in enumerate(
                _spread(comm, S, lambda s: (rsp.sphere_project_warp(
                    meshes[s], original, warped[s], device).coords,)))]
        if dedrift_warps:
            with trace.span("gmsm.dedrift"):
                native_warped = dedrift(native_warped, meshes[0], device,
                                        group)

        def resample(s):
            m = native_warped[s]
            carrier = Mesh(coords=m.coords, faces=m.faces,
                           data=np.atleast_2d(datasets[s]))
            res, _ = rsp.metric_resample(carrier, template, device=device)
            return (res.data,)
        with trace.span("gmsm.resample"):
            resampled = [r for (r,) in _spread(comm, S, resample)]

        with trace.span("gmsm.stats"):
            stack = np.stack(resampled)                      # (S,D,Nt)
            mean_map = stack.mean(axis=0)
            stdev_map = stack.std(axis=0)

            stats = {
                "cc": metrics.mean_pairwise_cc([r[0] for r in resampled]),
                "dice": metrics.mean_pairwise_dice(
                    [r[0] for r in resampled]),
            }
            per_subj = []
            for s, m in enumerate(native_warped):
                areal, shape = metrics.distortion_maps(meshes[s], m)
                per_subj.append(metrics.distortion_stats(areal, shape))
            for key in per_subj[0]:
                stats[key] = float(np.mean([d[key] for d in per_subj]))

        if outdir and comm.rank == 0:
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
                      mean_map=mean_map, stdev_map=stdev_map, stats=stats,
                      energies=list(gmr.energy_log))


def run_cgmsm(groups: dict, tree: List[tuple], datasets: dict, template: Mesh,
              config: RegConfig | str | None, verbose: bool = False,
              dedrift_warps: bool = True, device=None, group=None) -> dict:
    """Hierarchical cgMSM (run_cgMSM_ver_gw_iter.sh): walk a binary tree of
    groups; at each internal node, groupwise-register the two children's MEAN
    feature maps, dedrift the node's warps (the script's dedrifting phase,
    run_cgMSM_ver_gw_iter.sh:68-107), then project all member subjects
    through the node's (dedrifted) warp.

    groups: {group_id: [subject ids]}; tree: [(left, right, root), ...] in
    evaluation order; datasets: {subject id: (mesh, (D,N) data)}.
    Returns {group_id: {"members", "meshes": {subject: warped mesh},
    "mean": map}}.

    Over the ranks of `group` (None: this process alone) every rank passes
    everything and gets the whole state, bitwise that of one rank: the
    members' resamples and projections are split over the ranks and
    all-gathered in member order, and each node's 2-subject registration
    runs on the group's first two ranks (SubjectComm.for_subjects; a new
    group when the group has more than two ranks, so it must then span
    the default group), whose result the others receive by broadcast.
    Nodes run one after another, as in the JAX package."""
    device = resolve_device(device)
    comm = mh.SubjectComm(group)
    node_comm = comm.for_subjects(2)

    def resampled(mesh, sid):
        carrier = Mesh(coords=mesh.coords, faces=mesh.faces,
                       data=np.atleast_2d(datasets[sid][1]))
        res, _ = rsp.metric_resample(carrier, template, device=device)
        return res.data

    leaves = [(gid, sid) for gid, members in groups.items()
              for sid in members]
    maps = _spread(comm, len(leaves),
                   lambda i: (resampled(datasets[leaves[i][1]][0],
                                        leaves[i][1]),))
    state: dict = {}
    for gid, members in groups.items():
        state[gid] = {
            "members": list(members),
            "meshes": {s: datasets[s][0].copy() for s in members},
            "mean": np.mean([m for (g, _), (m,) in zip(leaves, maps)
                             if g == gid], axis=0),
        }

    for left, right, root in tree:
        lm = state[left]
        rm = state[right]
        if node_comm is not None:
            pair = GroupMeshRegistration(device=device, group=node_comm.group)
            tm = template.copy()
            pair.set_inputs([tm.copy(), tm.copy()])
            pair.set_data_list([lm["mean"], rm["mean"]])
            pair.set_template(template)
            pair.verbose = verbose
            pair.run_multiresolutions(config)
            node = [pair.sph_orig.coords, pair.sph_orig.faces] + [
                m.coords for m in pair.registered_spheres()]
        else:
            node = []
        if node_comm is not comm:
            node = comm.broadcast_arrays(node)
        original = Mesh(coords=node[0], faces=node[1])
        warped = [Mesh(coords=c, faces=original.faces) for c in node[2:]]
        if dedrift_warps:
            warped = dedrift(warped, original, device, group)

        sides = [(side, sid) for side, groupstate in ((0, lm), (1, rm))
                 for sid in groupstate["members"]]
        meshes = {**lm["meshes"], **rm["meshes"]}

        def project(i):
            side, sid = sides[i]
            w = rsp.sphere_project_warp(meshes[sid], original, warped[side],
                                        device)
            m = unfold(w, device=device)
            return m.coords, resampled(m, sid)
        done = _spread(comm, len(sides), project, width=2)
        state[root] = {
            "members": lm["members"] + rm["members"],
            "meshes": {sid: _like(meshes[sid], c)
                       for (_, sid), (c, _) in zip(sides, done)},
            "mean": np.mean([m for _, m in done], axis=0),
        }
    return state
