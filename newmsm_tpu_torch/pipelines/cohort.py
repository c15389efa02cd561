"""Cohort orchestration: clustering CSV -> group tree -> cgMSM execution.

In-process replacement for the reference's cluster-tree bookkeeping and
SLURM batch scripts (gMSM_scripts/):

  * ``extract_info``      — gMSM_scripts/extract_info.py:25-149: read the
    subject-clustering CSV and the full hierarchical-path CSV, drop groups
    below the study size threshold, and prune/splice the hierarchy down to
    the binary tree over the kept groups.
  * ``gen_order``         — gMSM_scripts/gen_order.py:16-65: expand the
    study tree into the per-subject registration rows and mean-generation
    rows, split into dependency blocks (the reference's blocks/block_N.txt).
  * ``run_cohort``        — run_cgMSM_ver_gw_iter.sh driven end-to-end from
    the two CSVs: extract_info -> execution order -> pipelines.gmsm.run_cgmsm.
  * ``register_dataset``  — newMSM_HCP_to_template_v2.sh /
    group_reg_dataset.sh: batch many per-subject registrations to a template
    in ONE process (host tables and the kernel build amortised over the
    cohort — the reference pays a full newmsm process per SLURM array task),
    with the wb_command -surface-distortion -log2 output produced natively.

File formats match the reference scripts line-for-line so existing cohort
CSVs drive this module unchanged. The bookkeeping is host-only; the two
entry points that register take a `device` (None means cuda).
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import trace
from ..core.mesh import Mesh
from ..eval import metrics


# --------------------------------------------------------------------------
# CSV inputs
# --------------------------------------------------------------------------

def read_clustering(path: str) -> Dict[str, List[str]]:
    """Subject-clustering CSV (line,subject,group) -> {group: [subjects]}
    (extract_info.py:70-76)."""
    groups: Dict[str, List[str]] = {}
    with open(path, newline="") as f:
        for row in csv.DictReader(f, fieldnames=["line", "subject", "group"]):
            groups.setdefault(row["group"], []).append(
                row["subject"].split("\n")[0])
    return groups


def read_hierarchy(path: str) -> List[Tuple[str, str, str]]:
    """Hierarchical-path CSV (left,right,root) rows (extract_info.py:97-102)."""
    out = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f, fieldnames=["left", "right", "root"]):
            out.append((row["left"], row["right"], row["root"]))
    return out


# --------------------------------------------------------------------------
# extract_info: prune the hierarchy to the study groups
# --------------------------------------------------------------------------

@dataclass
class StudyTree:
    groups: Dict[str, List[str]]           # kept groups only
    tree: List[Tuple[str, str, str]]       # (left,right,root), children first
    group_sizes: Dict[str, int]            # kept groups + internal nodes
    subjects: List[str]                    # all subjects in the study


def extract_info(clustering: Dict[str, List[str]] | str,
                 hierarchy: Sequence[Tuple[str, str, str]] | str,
                 root: str, min_size: int = 10) -> StudyTree:
    """Prune the full cluster hierarchy to the groups with >= min_size
    subjects (extract_info.py keeps ``num_subs > 9``), splicing out internal
    nodes left with a single studied child (the lone-leaf collapse,
    extract_info.py:120-141). Returns the induced binary tree in
    children-before-parents (execution) order."""
    if isinstance(clustering, str):
        clustering = read_clustering(clustering)
    if isinstance(hierarchy, str):
        hierarchy = read_hierarchy(hierarchy)

    kept = {g: s for g, s in clustering.items() if len(s) >= min_size}
    children = {r: (l, rg) for l, rg, r in hierarchy}

    tree: List[Tuple[str, str, str]] = []
    sizes = {g: len(s) for g, s in kept.items()}

    # iterative post-order (explicit stack): real clustering dendrograms can
    # be chain-like with thousands of nodes, far past Python's recursion limit
    rep: Dict[str, Optional[str]] = {}
    stack: List[Tuple[str, bool]] = [(root, False)]
    while stack:
        node, expanded = stack.pop()
        if node in rep:
            continue
        if node in kept:
            rep[node] = node
            continue
        ch = children.get(node)
        if ch is None:
            rep[node] = None
            continue
        if not expanded:
            stack.append((node, True))
            stack.extend((c, False) for c in ch if c not in rep)
            continue
        # children resolved: emit post-order (children before parents)
        reps = [r for r in (rep[c] for c in ch) if r is not None]
        if not reps:
            rep[node] = None
        elif len(reps) == 1:        # lone leaf: splice this node out
            rep[node] = reps[0]
        else:
            tree.append((reps[0], reps[1], node))
            sizes[node] = sizes[reps[0]] + sizes[reps[1]]
            rep[node] = node

    top = rep.get(root)
    if top is None:
        raise ValueError(f"no group reaches min_size={min_size} under {root}")
    subjects = [s for g in kept.values() for s in g]
    return StudyTree(groups=kept, tree=tree, group_sizes=sizes,
                     subjects=subjects)


def write_study_files(study: StudyTree, workdir: str,
                      prefix: str = "study") -> None:
    """The reference's side-effect files (extract_info.py:78-91,143-149):
    group_list.txt (group,size), subjects_in_study.txt, and the pruned
    hierarchical-path CSV (sorted by node id, the reference's dict order)."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "group_list.txt"), "w") as f:
        for g in study.groups:
            f.write(f"{g},{len(study.groups[g])}\n")
    with open(os.path.join(workdir, "subjects_in_study.txt"), "w") as f:
        for s in study.subjects:
            f.write(s + "\n")
    # NOTE: sorted lexicographically by node id for reference-file
    # compatibility (extract_info.py writes dict order) — this is NOT
    # execution order ('NODE10' < 'NODE9'); gen_order re-derives a
    # children-first order itself, so the round-trip through this CSV works.
    path = os.path.join(workdir, f"{prefix}_hierarchical_path.csv")
    with open(path, "w") as f:
        for left, right, node in sorted(study.tree, key=lambda t: t[2]):
            f.write(f"{left},{right},{node}\n")


# --------------------------------------------------------------------------
# gen_order: execution rows + dependency blocks
# --------------------------------------------------------------------------

def _children_first(groups: Dict[str, List[str]],
                    tree: Sequence[Tuple[str, str, str]]
                    ) -> List[Tuple[str, str, str]]:
    """Kahn-style topological sort of tree rows so every row's children are
    leaves or earlier rows' roots. Raises ValueError on unknown groups or
    cyclic/unsatisfiable rows (the CSV round-trip guarantee for gen_order)."""
    ready = set(groups)
    remaining = list(tree)
    out: List[Tuple[str, str, str]] = []
    while remaining:
        nxt = [row for row in remaining
               if row[0] in ready and row[1] in ready]
        if not nxt:
            bad = remaining[0]
            raise ValueError(
                f"tree row ({bad[0]},{bad[1]},{bad[2]}) references an "
                "unknown group/mean — not resolvable in any order")
        for row in nxt:
            out.append(row)
            ready.add(row[2])
            remaining.remove(row)
    return out


def gen_order(groups: Dict[str, List[str]],
              tree: Sequence[Tuple[str, str, str]]
              ) -> Tuple[List[str], List[List[str]]]:
    """Expand the study tree into the reference's order rows
    (gen_order.py:35-65): per subject '0,subject,own_group,sibling,root'
    registration rows and '1,NA,left,right,root' mean-generation rows,
    partitioned into blocks such that every row in a block only depends on
    earlier blocks. Returns (order_rows, blocks).

    The tree rows may arrive in any order (e.g. read back from the
    lexicographically sorted study CSV): they are topologically re-sorted
    children-first here. Unknown groups / unsatisfiable dependencies raise."""
    tree = _children_first(groups, tree)
    members = {g: list(s) for g, s in groups.items()}
    order: List[str] = []
    blocks: List[List[str]] = []
    reg_block: List[str] = []
    mean_block: List[str] = []
    available = set(groups)          # means usable without a new wave
    pending: set = set()             # means emitted but not yet flushed

    def flush():
        nonlocal reg_block, mean_block
        if reg_block:
            blocks.append(reg_block)
            reg_block = []
        if mean_block:
            order.extend(mean_block)
            blocks.append(mean_block)
            mean_block = []
        available.update(pending)
        pending.clear()

    for left, right, root in tree:
        if left in pending or right in pending:
            # depends on a mean generated in this wave: new dependency block
            flush()
        if left not in available or right not in available:
            raise ValueError(f"tree row ({left},{right},{root}) references "
                             "an unknown group/mean — rows must be "
                             "children-first (see extract_info)")
        for a, b in ((left, right), (right, left)):
            for subject in members[a]:
                row = f"0,{subject},{a},{b},{root}"
                order.append(row)
                reg_block.append(row)
                members.setdefault(root, []).append(subject)
        mean_block.append(f"1,NA,{left},{right},{root}")
        pending.add(root)
    flush()
    return order, blocks


# --------------------------------------------------------------------------
# end-to-end cohort run
# --------------------------------------------------------------------------

@dataclass
class CohortResult:
    state: dict          # cgMSM state keyed purely by group/node id
    study: StudyTree     # the pruned study tree that drove the run

    def __getitem__(self, key):         # convenience: result["N1"]
        return self.state[key]


def run_cohort(clustering: str | Dict[str, List[str]],
               hierarchy: str | Sequence[Tuple[str, str, str]],
               root: str,
               datasets: Dict[str, tuple],
               template: Mesh,
               config,
               min_size: int = 10,
               verbose: bool = False,
               dedrift_warps: bool = True, device=None,
               group=None) -> CohortResult:
    """cgMSM straight from the clustering + hierarchy CSVs
    (run_cgMSM_ver_gw_iter.sh orchestrated by extract_info/gen_order):
    prune the tree, then walk it children-first with pipelines.gmsm.run_cgmsm
    over the ranks of `group` (None: this process alone; see run_cgmsm).

    datasets: {subject: (Mesh, (D,N) data)} for every subject that may be in
    the study; unused (small-group) subjects are ignored.
    Returns CohortResult(state, study): state is the cgMSM dict keyed purely
    by group/node id (see run_cgmsm), study the pruned StudyTree.
    `device` None means cuda.
    """
    from .gmsm import run_cgmsm
    study = extract_info(clustering, hierarchy, root, min_size)
    missing = [s for s in study.subjects if s not in datasets]
    if missing:
        raise ValueError(f"datasets missing study subjects: {missing[:5]}")
    state = run_cgmsm(study.groups, study.tree, datasets, template, config,
                      verbose=verbose, dedrift_warps=dedrift_warps,
                      device=device, group=group)
    return CohortResult(state=state, study=study)


# --------------------------------------------------------------------------
# batch pairwise-to-template driver
# --------------------------------------------------------------------------

@dataclass
class DatasetResult:
    per_subject: Dict[str, dict] = field(default_factory=dict)
    failed: Dict[str, str] = field(default_factory=dict)


def register_dataset(subjects: Sequence[str],
                     mesh: Mesh,
                     template_data: np.ndarray,
                     config,
                     data: Callable[[str], np.ndarray] | Dict[str, np.ndarray],
                     outdir: str = "",
                     verbose: bool = False,
                     save_distortion: bool = True,
                     device=None) -> DatasetResult:
    """Register every subject of a cohort to a template in one process
    (newMSM_HCP_to_template_v2.sh:23-40 / group_reg_dataset.sh — there, one
    newmsm process + one wb_command call per SLURM array task).

    All subjects share `mesh` (the common ico sphere) and `config`, so the
    whole batch reuses one process's cached host tables and built kernel.
    Per subject this writes
    <subject>.sphere.reg + <subject>.transformed_and_reprojected(+distortion)
    and records CC-to-template plus distortion stats.

    data: mapping or callable subject -> (D,N) feature array (the reference
    reads $subject.sulc.curv.affine.ico6.shape.gii). `device` None means
    cuda.

    One rank, one subject after another, as in the JAX package: it takes no
    process group. Splitting the subjects over ranks, as the reference's
    SLURM array does, would be a feature the JAX package lacks.
    """
    from .. import resolve_device
    from ..reg.driver import MeshRegistration

    device = resolve_device(device)

    get = data.__getitem__ if isinstance(data, dict) else data
    tdata = np.atleast_2d(np.asarray(template_data))
    result = DatasetResult()
    if outdir:
        os.makedirs(outdir, exist_ok=True)

    for subject in subjects:
        try:
            mr = MeshRegistration(device=device)
            # the driver's metrics (if its metrics_path is set) take in the
            # post-processing too, as one unit
            with trace.run(mr.metrics_path, mr.device):
                mr.set_input(mesh.copy())
                mr.set_reference(mesh.copy())
                mr.set_input_data(np.atleast_2d(np.asarray(get(subject))))
                mr.set_reference_data(tdata)
                mr.verbose = verbose
                # per-subject prefix even without outdir: the driver
                # otherwise writes its default './' outputs and each subject
                # would silently overwrite the previous one's
                # sphere.reg/transformed
                mr.outdir = os.path.join(outdir or ".", f"{subject}.MSM.")
                mr.run_multiresolutions(config)

                # driver already wrote sphere.reg/transformed per subject
                with trace.span("subject.post"):
                    areal, shape = metrics.distortion_maps(mr.in_mesh,
                                                           mr.warped_input)
                    stats = metrics.distortion_stats(areal, shape)
                    # CC over ALL feature channels (flattened (D,N)), not
                    # just ch 0
                    stats["cc"] = metrics.cross_correlation(
                        np.asarray(mr.transformed_data).ravel(),
                        tdata.ravel())
                    result.per_subject[subject] = stats
                    if outdir and save_distortion:
                        # wb_command -surface-distortion
                        # -local-affine-method -log2
                        dist = Mesh(coords=mr.in_mesh.coords,
                                    faces=mr.in_mesh.faces,
                                    data=np.stack([areal, shape]))
                        dist.save(os.path.join(
                            outdir,
                            f"{subject}.MSM.sphere.distortion.func.gii"))
        except Exception as e:       # isolate failures like SLURM array tasks
            result.failed[subject] = str(e)
            if verbose:
                print(f"  subject {subject} FAILED: {e}")
    return result
