#!/usr/bin/env python3
"""Smoke run of the PyTorch port (newmsm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--warm-runs N] [--profile-group]

Phases, each printing its own lines; any failure exits non-zero and prints
no result line:

  1. device   require CUDA; print the card's name and power limit
              (nvidia-smi) and the torch / CUDA versions;
  2. build    compile the kernels (csrc/locate_bary.cu, K1,
              csrc/icm_binary.cu, K2, csrc/rigid_cost.cu, K3, and
              csrc/label_forward.cu, K4) with nvcc; print their ptxas
              lines (registers, spills) and K1's resident grid;
  3. kernel   K1 against its plain PyTorch version on the card:
              2^20 random directions plus every vertex of ico-res, res in
              {0,2,4,6}; row sums, reconstructed positions, vertex mass and
              face-id agreement;
              then queries off the sphere (radius 0.5 to 150, as the
              anatomical cost sends them) in one call of 1,966,080, the
              size of a triclique call at ico-6;
              then K2 against its plain version (ops/icm.py
              icm_binary_twin) in its three forms (triplet,
              pair, group) at ico-2/3/4 and the group's N for S = 8:
              bit for bit on small-integer tables, and two launches
              equal on Gaussian tables;
              then K3 against its plain version (ops/rigid.py
              rigid_terms_twin) at AFFINE's ico-5 shape and at the edges of
              its arithmetic: each source's jp and the total within
              ops/rigid_bench.py's tolerances, two calls bit for bit;
              then K4 against its plain version on the CPU (ops/labelmap.py
              label_forward_twin) at the gMSM levels' data grids ico-4/5/6
              with their 19/19/18 labels and the ico-6 template: triangles
              and weights within ops/labelmap_bench.py's tolerances;
  4. main     the pairwise strain-registration path through the CLI
              (config_standard_MSM_strain, --it cut to 10,3,3,3) on an ico-6
              synthetic subject; checks outputs, folds, the sulc CC gain and
              that the path went through the kernel; prints the first
              set-up seconds of each level (the cold host table builds);
  5. msmpair  config_standard_MSMpair (regoption 1, the pairwise rotation
              regulariser; --it cut to 10,3,3,3) on the same subject: also
              checks that no chosen labeling lands on a FOLDING-gated pair;
  6. amsm     the structure of the aMSM longitudinal recipe (regoption 5 +
              triclique, three levels, anatomical meshes) on an ico-6
              longitudinal pair: also checks anat.reg.surf.gii and the
              4-row STRAINS.func.gii. Not the reference's config file
              verbatim, which is not in this repository;
  7. multimodal  the structure of the HCP multimodal recipe (regoption 3 +
              triclique, three levels) on an ico-6 multimodal_cohort
              subject with 10 channels (the multivariate triclique
              likelihood): every channel's CC to the template raised, peak
              device memory. Not the reference's config file verbatim;
  8. mcmc     one --dopt=MCMC --regoption=3 run at small depth (CP ico-2/3,
              1280 draws a level): energies, folds, seconds per sweep;
  9. group    the groupwise path (gMSM) through the CLI with list files:
              the gMSM tutorial config (CP 2/3/4, SG 4/5/6, datagrid 4/5/6,
              lambda 0.3, HOCR, regoption 3; --it cut to 2,2,2) on 6 ico-6
              synthetic subjects and an ico-6 template; checks one sphere
              and one transformed map a subject, folds, energies, that the
              patches were not truncated, the mean pairwise sulc CC and the
              kernel's launches; then pipelines.gmsm.dedrift on those
              spheres and one small run_gmsm call (3 subjects, ico-4);
 10. group_sharded  the subject-sharded group path on the same inputs and
              config: the CLI under `torch.distributed.run --standalone
              --nproc_per_node=2 ... --dist-backend gloo` (two ranks sharing
              the card), then the ring maps exchange at two spawned ranks on
              the config's first two levels, then the CLI under NCCL when
              there are two cards; energies, and the CLI's spheres, bitwise
              those of phase 9; per-rank stage seconds, launches and peak
              memory;
 11. gmsm_ranks  pipelines.gmsm.run_gmsm (registration, dedrift, resamples,
              group statistics) on 8 ico-6 subjects, the reference's
              8-subject tier, with phase 9's config: first in this process
              on one rank, then over 2 ranks spawned by
              multihost.run_local_ranks (gloo, both on the one card; NCCL,
              one card a rank, when there are two cards); energies,
              dedrifted spheres, mean / stdev maps and stats bitwise equal,
              0 folds, patch_overflow 0 at each level's end, the mean
              pairwise CC raised, K1's and K4's launches summed over the
              ranks equal to the one-rank run's; prints the pair-block batches of each
              level (S = 8 has 28 blocks: the chunked branch), per-rank peak
              memory, setup_s / opt_s of each iteration and the walls;
 12. timing   K1 and its plain version at the shape of the main
              path's largest locate call: windows of back-to-back launches
              between CUDA events (median and spread), the SM clock and
              power sampled under the load, the roofline bound and the
              issue-slot bound from the SASS instruction count; then K2
              and its plain version a move at the ico-4 strain shape and
              the gmsm_s8 last-level shape, beside the chain of passes x
              colours block barriers; then K3 and its plain version a cost
              evaluation at ico-5 (D = 2 cosine, D = 10 SSD), beside the
              bound of the call's gates and neighbourhood pairs; then K4
              and its plain version on the card a call at the gMSM levels'
              data grids, beside the bound of the call's distances.

Phases 4 to 9 and phase 11's one-rank run each zero the kernels' tallies
(ops/_build.py) before the call and read them after; the ranks of phases
10 and 11 are fresh processes, whose tallies start at 0 and are read from
each rank. On every path each kernel is held to its metrics file
(`check_kernels`): rank 0's launches equal its `<kernel>.kernel` counts,
nothing counts `<kernel>.twin`, every rank launched K1, and every rank
launched K2 once a fusion move or alpha step and K3 once a cost
evaluation of AFFINE (none on the paths without it), and every rank of a
group path launched K4 once a subject it owns and a `group.maps` span
(none on the pairwise paths). Any mismatch fails the run, and so does a
failing rank.
The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}. Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

KERNEL_SOURCE = "newmsm_tpu_torch/csrc/locate_bary.cu"
KERNEL_REPLACES = "newmsm_tpu/ops/pallas_locate.py:179"

# config_standard_MSM_strain (scripts/parity_harness.py TYPICAL_CONFIG)
# verbatim except the iteration counts, 50,20,25,25 -> 10,3,3,3
STANDARD_ITERS = "50,20,25,25"
SMOKE_ITERS = "10,3,3,3"
MAIN_RES = 6            # data grid of the last level: the locate's `res`
STRAIN_CONFIG = f"""\
--simval=2,2,2,2
--sigma_in=2,4,2,1
--sigma_ref=2,4,2,1
--lambda=0,0.2,0.2,0.2
--it={SMOKE_ITERS}
--opt=AFFINE,DISCRETE,DISCRETE,DISCRETE
--CPgrid=0,2,3,4
--SGgrid=0,4,5,6
--datagrid=5,5,5,6
--regoption=3
--regexp=2
--dopt=HOCR
--VN
--k_exponent=2
--bulkmod=1.6
--shearmod=0.4
--rescaleL
"""


# config_standard_MSMpair (the reference's second basic config: the
# pairwise rotation regulariser, solved on the fusion pair path) verbatim
# except the iteration counts, 50,5,10,10 -> 10,3,3,3
MSMPAIR_STANDARD_ITERS = "50,5,10,10"
MSMPAIR_CONFIG = f"""\
--sigma_in=6,6,4,2
--sigma_ref=6,6,4,2
--lambda=0,0.1,0.2,0.3
--it={SMOKE_ITERS}
--opt=AFFINE,DISCRETE,DISCRETE,DISCRETE
--CPgrid=0,2,3,4
--SGgrid=0,4,5,6
--datagrid=5,5,5,6
--regoption=1
"""

# The STRUCTURE of the reference's aMSM longitudinal recipe
# (NeuroImage2017 aMSM_STR_longitudinal_alignment: regoption 5, triclique,
# three levels CP 2/3/4, data and anatomical grids 4/5/6) with the strain
# parameters of config_standard_MSM_strain and --it=2,2,2. The reference's
# file itself is not in this repository, so this is not that file verbatim.
AMSM_ITERS = "2,2,2"
AMSM_CONFIG = f"""\
--simval=2,2,2
--sigma_in=2,2,1
--sigma_ref=2,2,1
--lambda=0.2,0.2,0.2
--it={AMSM_ITERS}
--opt=DISCRETE,DISCRETE,DISCRETE
--CPgrid=2,3,4
--SGgrid=4,5,6
--datagrid=4,5,6
--anatgrid=4,5,6
--regoption=5
--triclique
--regexp=2
--dopt=HOCR
--VN
--k_exponent=2
--bulkmod=1.6
--shearmod=0.4
"""

# The STRUCTURE of the reference's HCP multimodal recipe
# (HCP_multimodal_alignment MSMAllStrainFinalconf1to1_1to3_2: regoption 3
# with the triclique data term, three discrete levels): AMSM_CONFIG without
# --anatgrid and with --regoption=3, so CP 2/3/4, SG 4/5/6, datagrid 4/5/6
# and the strain parameters of config_standard_MSM_strain, --it=2,2,2. Not
# the reference's config file verbatim, which is not in this repository.
MULTIMODAL_CONFIG = AMSM_CONFIG.replace("--anatgrid=4,5,6\n", "").replace(
    "--regoption=5", "--regoption=3")
MULTIMODAL_CHANNELS = 10

# a small-depth MCMC run: two discrete levels, 1280 draws a level
# (10 sweeps of 128 proposals); the reference default is 100000
MCMC_CONFIG = """\
--simval=2,2
--sigma_in=4,2
--sigma_ref=4,2
--lambda=0.2,0.2
--it=3,3
--opt=DISCRETE,DISCRETE
--CPgrid=2,3
--SGgrid=4,5
--datagrid=4,5
--mciters=1280,1280
--regoption=3
--regexp=2
--dopt=MCMC
--VN
--k_exponent=2
--bulkmod=1.6
--shearmod=0.4
"""

# the gMSM tutorial example config (scripts/parity_harness.py
# GROUPWISE_CONFIG, from docs/guide.md:394-411 with lambda 0.3) verbatim
# except the iteration counts, 9,9,9 -> 2,2,2
GROUP_STANDARD_ITERS = "9,9,9"
GROUP_ITERS = "2,2,2"
GROUP_SUBJECTS = 6
GROUP_CONFIG = f"""\
--simval=2,2,2
--sigma_in=0,0,0
--sigma_ref=0,0,0
--lambda=0.3,0.3,0.3
--it={GROUP_ITERS}
--opt=DISCRETE,DISCRETE,DISCRETE
--CPgrid=2,3,4
--SGgrid=4,5,6
--datagrid=4,5,6
--regoption=3
--regexp=2
--dopt=HOCR
--k_exponent=2
--bulkmod=1.6
--shearmod=0.4
"""
# the harness's FAST_GROUPWISE (data grids 3/4/4, CP 1/2/2, SG 3/4/4) with
# --it=2,2,2, for the small run_gmsm call
GROUP_SMALL_CONFIG = GROUP_CONFIG.replace(
    "--datagrid=4,5,6", "--datagrid=3,4,4").replace(
    "--CPgrid=2,3,4", "--CPgrid=1,2,2").replace(
    "--SGgrid=4,5,6", "--SGgrid=3,4,4")

# phase_gmsm_ranks: the reference's 8-subject tier (run_gMSM.sh:14-22
# picks its config by group size, 4 / 8 / 16)
GMSM_SUBJECTS = 8

# the last level of GROUP_CONFIG alone, one iteration: the --profile run
GROUP_LAST_LEVEL_CONFIG = """\
--simval=2
--sigma_in=0
--sigma_ref=0
--lambda=0.3
--it=1
--opt=DISCRETE
--CPgrid=4
--SGgrid=6
--datagrid=6
--regoption=3
--regexp=2
--dopt=HOCR
--k_exponent=2
--bulkmod=1.6
--shearmod=0.4
"""

# one triclique likelihood call at ico-6: 5,120 CP faces x 8 combinations
# x 48 patch slots
BIG_CALL_QUERIES = 5120 * 8 * 48


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return card


def phase_build():
    from newmsm_tpu_torch.ops import _build, icm, labelmap, locate, rigid
    t0 = time.perf_counter()
    for k in (locate, icm, rigid, labelmap):
        k.SEAM.library()
    print(f"build: {locate.SOURCE}, {icm.SOURCE}, {rigid.SOURCE} and "
          f"{labelmap.SOURCE} ready (nvcc at first use) in "
          f"{time.perf_counter() - t0:.2f} s")
    name = f"{locate.KERNEL}ILi{MAIN_RES}E"
    print(f"build: ptxas, res {MAIN_RES} kernel: "
          f"{_build.ptxas_usage(locate.SOURCE, name)}")
    for form, args in (("t8, shared x", "ILb1ELb0ELb1E"),
                       ("p4, shared x", "ILb0ELb1ELb1E"),
                       ("t8 + p4, shared x", "ILb1ELb1ELb1E"),
                       ("t8 + p4, x in device memory", "ILb1ELb1ELb0E")):
        print(f"build: ptxas, K2 {form}: "
              f"{_build.ptxas_usage(icm.SOURCE, icm.KERNEL + args)}")
    for name in (rigid.KERNEL, "rigid_combine_kernel"):
        print(f"build: ptxas, K3 {name}: "
              f"{_build.ptxas_usage(rigid.SOURCE, name)}")
    print(f"build: ptxas, K4 {labelmap.KERNEL}: "
          f"{_build.ptxas_usage(labelmap.SOURCE, labelmap.KERNEL)}")
    print(f"build: grid capped at {locate.resident_blocks(MAIN_RES, 'cuda')} "
          f"resident blocks (occupancy x SMs)")


def _k1_against_twin(torch, q, res, where, n_rand):
    """One K1 call on the card against its plain version on the queries q
    (Q,3), held to the tolerances of the JAX package's on-device probe
    (pallas_locate.py:149-158): finite weights, row sums within 1e-4,
    positions within 2e-4 (unit sphere), weights >= -1e-4, face ids
    differing (boundary ties) on at most 1e-4 of the first n_rand (random)
    queries. Returns the kernel's and the twin's face ids and (Q,3)
    float64 weights, and the position error."""
    from newmsm_tpu_torch.core.icosphere import icosphere
    from newmsm_tpu_torch.ops import locate
    ico = icosphere(res)
    px, py, pz = (q[:, i].contiguous() for i in range(3))
    got = (locate.locate_bary(px, py, pz, res),
           locate.locate_bary_reference(px, py, pz, res))
    torch.cuda.synchronize()
    (fk, Wk), (fp, Wp) = ((fid.cpu().numpy(),
                           torch.stack(w, 1).double().cpu().numpy())
                          for fid, *w in got)
    pos_k, pos_p = ((ico.coords[ico.faces[f]] * W[..., None]).sum(1)
                    for f, W in ((fk, Wk), (fp, Wp)))
    pos_err = float(np.abs(pos_k - pos_p).max())
    row_err = float(np.abs(Wk.sum(1) - 1.0).max())
    mism = int((fk[:n_rand] != fp[:n_rand]).sum())
    print(f"kernel res {res}{where}: queries {len(fk)} fid_mismatch "
          f"{mism}/{n_rand} pos_err {pos_err:.3e} row_err {row_err:.3e} "
          f"min_w {Wk.min():.3e}")
    tag = f"res {res}{where}"
    check(np.isfinite(Wk).all(), f"{tag}: non-finite weights")
    check(row_err < 1e-4, f"{tag}: row sums off by {row_err}")
    check(pos_err < 2e-4, f"{tag}: position error {pos_err}")
    check(Wk.min() >= -1e-4, f"{tag}: negative weight {Wk.min()}")
    check(mism <= 1e-4 * n_rand, f"{tag}: {mism} face-id mismatches")
    return fk, fp, Wk, Wp, pos_err


def phase_kernel(torch):
    """K1 against its plain version on the card: random directions plus
    every vertex, then queries off the sphere in one large call; then K2
    and K3 against theirs."""
    from newmsm_tpu_torch.core.icosphere import icosphere

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    n_rand = 1 << 20
    worst_pos = 0.0
    for res in (0, 2, 4, 6):
        ico = icosphere(res)
        q = torch.randn((n_rand, 3), generator=g, dtype=torch.float32)
        q = q / torch.linalg.norm(q, dim=1, keepdim=True) * 100.0
        q = torch.cat([q, torch.as_tensor(ico.coords * 100.0,
                                          dtype=torch.float32)]).to(dev)
        fk, fp, Wk, Wp, pos_err = _k1_against_twin(torch, q, res, "", n_rand)
        same = fk == fp
        w_err = float(np.abs(Wk[same] - Wp[same]).max())
        # a vertex query lands on an incident face with mass 1 (1e-3)
        vid = np.arange(ico.nvertices)
        hit = ico.faces[fk[n_rand:]] == vid[:, None]
        vmass = float(np.abs(Wk[n_rand:][hit] - 1.0).max()) if hit.any() \
            else 1.0
        print(f"kernel res {res}: w_err_same_face {w_err:.3e} "
              f"vertex_mass_err {vmass:.3e}")
        check(bool(hit.any(axis=1).all()),
              f"res {res}: a vertex query landed on a non-incident face")
        check(vmass < 1e-3, f"res {res}: vertex mass error {vmass}")
        worst_pos = max(worst_pos, pos_err)

    # off the sphere, one large call: the anatomical cost (regoption 5)
    # queries raw barycentric combinations, and a triclique call at ico-6
    # is twice the largest unary call
    q = torch.randn((BIG_CALL_QUERIES, 3), generator=g, dtype=torch.float32)
    q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    radius = 0.5 + 149.5 * torch.rand((BIG_CALL_QUERIES, 1), generator=g)
    *_, pos_err = _k1_against_twin(torch, (q * radius).to(dev), MAIN_RES,
                                   ", off-sphere radius 0.5..150",
                                   BIG_CALL_QUERIES)
    phase_icm_kernel()
    phase_rigid_kernel()
    phase_labelmap_kernel()
    return max(worst_pos, pos_err)


# K2's forms and sizes: (form, control-grid level, subjects)
ICM_CASES = (("t8", 2, 1), ("t8", 3, 1), ("t8", 4, 1), ("p4", 2, 1),
             ("p4", 3, 1), ("p4", 4, 1), ("group", 4, GMSM_SUBJECTS))


def _icm_problem(form, res, S, integer, seed=0):
    from newmsm_tpu_torch.ops import icm_bench
    if form == "group":
        return icm_bench.group_problem(S, res, "cuda", seed, integer)
    return icm_bench.pairwise_problem(res, form, "cuda", seed, integer)


def phase_icm_kernel():
    """K2 against its plain version, as tests/test_torch_cuda.py holds it:
    on small-integer tables (exact float32 sums) equal bit for bit; on
    Gaussian tables two launches equal (the rows that differ from the
    plain version and the largest energy gap are printed)."""
    from newmsm_tpu_torch.ops import icm_bench
    for form, res, S in ICM_CASES:
        exact = icm_bench.compare(_icm_problem(form, res, S, True))
        real = icm_bench.compare(_icm_problem(form, res, S, False, seed=1))
        print(f"K2 {form} ico-{res} S={S}: integer tables xs/es equal "
              f"{exact['xs_equal']}/{exact['es_equal']}; Gaussian tables "
              f"rows differing {real['rows_differ']}, energy gap "
              f"{real['energy_rel_gap']:.2e}, chosen same "
              f"{real['chosen_same']}; repeats "
              f"{exact['repeats'] and real['repeats']}")
        check(exact["xs_equal"] and exact["es_equal"],
              f"K2 {form} ico-{res}: differs from its twin on exact tables")
        check(exact["repeats"] and real["repeats"],
              f"K2 {form} ico-{res}: two launches differ")


# K3's cases: (control-grid level, channels, simval, problem options), as
# tests/test_torch_cuda.py holds them
RIGID_CASES = ((5, 2, 2, {}), (5, 10, 1, {}), (5, 10, 2, {}),
               (5, 2, 2, {"n_src": 2 * 2048 + 2}), (5, 2, 2, {"degrees": 0.0}),
               (4, 2, 2, {"northern_targets": True}),
               (4, 3, 2, {"zero_columns": True}),
               (4, 3, 1, {"zero_columns": True}))


def phase_rigid_kernel():
    """K3 against its plain version at AFFINE's shape and at the edges of
    its arithmetic (ops/rigid_bench.py's tolerances), two calls bit for
    bit."""
    from newmsm_tpu_torch.ops import rigid_bench as rb
    for res, channels, simval, opts in RIGID_CASES:
        got = rb.compare(rb.problem(res, channels, simval, "cuda", **opts))
        print(f"K3 ico-{res} D={channels} simval {simval} {opts}: total "
              f"{got['total_kernel']:.6f} / twin {got['total_twin']:.6f} "
              f"(gap {got['total_gap']:.2e} of sum |jp|), jp gap "
              f"{got['jp_gap']:.2e}, gate ties {got['ties']} of "
              f"{got['sources']}, unexplained {got['unexplained']}, empty {got['empty_kernel']} / "
              f"{got['empty_twin']}; repeats {got['repeats']}")
        check(got["ok"], f"K3 ico-{res} D={channels} simval {simval} {opts}: "
                         f"differs from its twin: {got}")
        check(got["empty_kernel"] == got["empty_twin"],
              f"K3 {opts}: empty neighbourhoods differ from its twin's")


def phase_labelmap_kernel():
    """K4 against its plain version on the CPU at the data grids of the
    gMSM levels (ops/labelmap_bench.py's tolerances)."""
    from newmsm_tpu_torch.ops import labelmap_bench as lb
    for res in sorted(lb.LEVELS):
        got = lb.compare(lb.problem(res, "cpu"))
        print(f"K4 data grid ico-{res}, {got['labels']} labels: rows "
              f"differing {got['differing']} of {got['rows']} (share "
              f"{got['share']:.2e}, near ties {got['near_ties']}), weight "
              f"gap {got['w_gap']:.2e}, weights bit for bit "
              f"{got['w_bits_equal']}")
        check(got["ok"], f"K4 ico-{res}: differs from its twin: {got}")


def phase_labelmap_timing():
    """K4 a call at the data grids of the gMSM levels and the ico-6
    template, and its plain version on the card, beside the bound of the
    call's distances (ops/labelmap_bench.py)."""
    from newmsm_tpu_torch.ops import labelmap_bench as lb
    out = {}
    for res in sorted(lb.LEVELS):
        out[f"ico{res}"] = t = lb.time_forward(lb.problem(res, "cuda"))
        print(f"K4 time data grid ico-{res} (L {t['labels']}, N "
              f"{t['grid']}, Nt {t['template']}): kernel "
              f"{t['kernel_ms']:.4f} ms a call (ms_spread "
              f"{t['kernel_ms_spread']:.3f}), plain {t['plain_ms']:.2f} ms; "
              f"bound {t['bound_ms']:.4f} ms by operations "
              f"({t['distances']} distances, {t['flops']} flops), share "
              f"{t['share']:.3f}; clock samples {t['clock_samples_mhz_w']}")
    return out


def phase_rigid_timing():
    """K3 a cost evaluation at AFFINE's ico-5 shapes: the card's time of
    a call, a whole evaluation at the host's pace (rotation and K3), and
    the plain version, beside the bound (ops/rigid_bench.py)."""
    from newmsm_tpu_torch.ops import rigid_bench as rb
    out = {}
    for name, make in rb.SHAPES.items():
        out[name] = t = rb.time_cost(make("cuda"))
        print(f"K3 time {name} (N {t['sources']}, Nt {t['targets']}, D "
              f"{t['channels']}): kernel {t['kernel_ms']:.4f} ms a call "
              f"(ms_spread {t['kernel_ms_spread']:.3f}), a whole evaluation "
              f"at the host's pace {t['evaluation_ms']:.4f} ms, plain "
              f"{t['plain_ms']:.3f} ms; bound {t['bound_ms']:.5f} ms by "
              f"{t['bound_by']} ({t['gates']} gates, {t['pairs']} pairs "
              f"through the gate, {t['ops']} operations, {t['bytes']} "
              f"bytes), share {t['share']:.3f}; clock samples "
              f"{t['clock_samples_mhz_w']}")
    return out


def phase_timing(torch, n_queries: int, res: int):
    """Times of the kernel (windows of 200 launches after 50 warm-ups) and
    of its plain version (windows of 5) on one locate call of the main
    path's shape, beside the roofline and issue-slot bounds."""
    from newmsm_tpu_torch.ops import locate, locate_bench as lb
    dev = torch.device("cuda", torch.cuda.current_device())
    k = lb.bench_source(locate.SOURCE, res, n_queries)
    px, py, pz = lb.random_queries(n_queries, dev)
    plain = lb.time_launches(
        lambda: locate.locate_bary_reference(px, py, pz, res), windows=3,
        launches=5, warmup=2)
    roof = lb.roofline(res, n_queries)
    print(f"kernel time res {res}, {n_queries} queries: kernel "
          f"{k['ms']:.4f} ms (windows {[round(x, 4) for x in k['windows_ms']]}"
          f", ms_spread {k['ms_spread']:.3f}, {k['rounds']} rounds), plain "
          f"{plain['ms']:.4f} ms (ms_spread {plain['ms_spread']:.3f})")
    print(f"clock samples under the kernel load (SM MHz, W): "
          f"{k['clock_samples_mhz_w']}")
    print(f"bound: {roof['bound_ms']:.5f} ms by {roof['bound_by']} "
          f"({lb.flops_per_query(res)} flops and {lb.BYTES_PER_QUERY} bytes "
          f"a query; bytes alone {roof['bytes_ms']:.5f} ms), share "
          f"{roof['bound_ms'] / k['ms']:.3f}")
    check(k["issue_slot_ms"] is not None,
          "no SM clock sample was taken under the kernel load")
    print(f"issue-slot bound: {k['sass_instructions']} SASS "
          f"instructions a query at {k['sm_mhz']:.0f} MHz -> "
          f"{k['issue_slot_ms']:.5f} ms, share "
          f"{k['issue_slot_ms'] / k['ms']:.3f}")
    print(f"SASS by opcode: {k['sass_opcodes']}")
    return k, plain, roof


def phase_icm_timing():
    """K2 and its plain version a move, at the ico-4 strain shape and the
    gmsm_s8 last-level shape, beside K2's floors: the same launch with
    empty colour groups (the chain of cluster barriers alone) and with no
    tables (a barrier and one dependent gather a step), all on the card's
    clock, and the host's rate of launches (ops/icm_bench.py)."""
    from newmsm_tpu_torch.ops import icm_bench
    out = {}
    for name, make in icm_bench.SHAPES.items():
        out[name] = t = icm_bench.time_move(make("cuda"))
        print(f"K2 time {name} ({t['nodes']} nodes, {t['starts']} starts, "
              f"{t['barrier_chain']} barrier steps): kernel "
              f"{t['kernel_ms']:.4f} ms a move (ms_spread "
              f"{t['kernel_ms_spread']:.3f}), plain {t['plain_ms']:.3f} ms; "
              f"floors: barriers alone {t['barrier_floor_ms']:.4f} ms "
              f"({t['barrier_step_us']:.2f} us a step), one dependent "
              f"gather a node {t['gather_floor_ms']:.4f} ms "
              f"({t['gather_step_us']:.2f} us a step), kernel "
              f"{t['kernel_step_us']:.2f} us a step; share of the gather "
              f"floor {t['floor_share']:.3f}; the host's launch rate "
              f"{t['host_launch_ms']:.4f} ms a launch")
    return out


def _cc(a, b) -> float:
    return float(np.corrcoef(a, b)[0, 1])


def write_inputs(workdir, tag, in_mesh, in_data, ref_mesh, ref_data,
                 anat=None):
    """Write one subject's GIFTI files; returns the CLI arguments that
    name them."""
    from newmsm_tpu_torch.core.mesh import Mesh
    paths = {}
    for name, mesh, data in (("in", in_mesh, in_data),
                             ("ref", ref_mesh, ref_data)):
        paths[name] = (os.path.join(workdir, f"{tag}_{name}.surf.gii"),
                       os.path.join(workdir, f"{tag}_{name}.func.gii"))
        mesh.save(paths[name][0])
        Mesh(coords=mesh.coords, faces=mesh.faces, data=data).save(
            paths[name][1])
    args = ["--inmesh", paths["in"][0], "--refmesh", paths["ref"][0],
            "--indata", paths["in"][1], "--refdata", paths["ref"][1]]
    if anat is not None:
        for flag, name, mesh in (("--inanat", "in", anat[0]),
                                 ("--refanat", "ref", anat[1])):
            path = os.path.join(workdir, f"{tag}_{name}.anat.surf.gii")
            mesh.save(path)
            args += [flag, path]
    return args


def span_total(events, name) -> int:
    """Sum of counter `name` (a mark's n, or a count) over the span lines
    of a metrics file."""
    total = 0
    for e in events:
        c = e["counters"].get(name) if e.get("event") == "span" else None
        if c is not None:
            total += c["n"] if isinstance(c, dict) else c
    return total


def tallies() -> dict:
    """A copy of each kernel's tally in this process: {name: {"kernel",
    "twin", "largest"}}."""
    from newmsm_tpu_torch.ops import icm, labelmap, locate, rigid
    return {k.SEAM.name: dict(k.SEAM.tally)
            for k in (locate, icm, rigid, labelmap)}


def measured(torch, fn):
    """fn() on the card, the kernels' tallies and the peak device memory
    zeroed first: (its result, wall seconds, [`tallies()`], peak device
    bytes)."""
    from newmsm_tpu_torch.ops import _build
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_tallies()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, [tallies()],
            torch.cuda.max_memory_allocated())


def launched(by_rank, name) -> int:
    """Launches of kernel `name` summed over a path's ranks."""
    return sum(t[name]["kernel"] for t in by_rank)


def largest_call(by_rank) -> int:
    """The most queries of one K1 launch on any of a path's ranks."""
    return max(t["locate"]["largest"] for t in by_rank)


def check_kernels(tag, by_rank, events, move):
    """Each kernel's launches on one path, from the tallies of its ranks
    (rank 0 first; a kernel a rank does not report is skipped), against
    the path's metrics file, which rank 0 writes: rank 0's launches equal
    the spans' `<name>.kernel` counts and no span counts `<name>.twin`;
    every rank launched K1; every rank launched K2 once a `move` mark
    (each rank runs the whole ICM) and K3 once a `cost_evals` count (none
    on a path without AFFINE); every rank launched K4 as often, and every
    `group.maps` span counts the same K4 launches, one a subject the rank
    owns (none on a pairwise path)."""
    for name, per in (("locate", None), ("icm", move),
                      ("rigid", "cost_evals"), ("labelmap", "group.maps")):
        if name not in by_rank[0]:
            continue
        n = [t[name]["kernel"] for t in by_rank]
        kernel = span_total(events, f"{name}.kernel")
        twin = span_total(events, f"{name}.twin")
        line = (f"{name} launches by rank {n}, {name}.kernel counts "
                f"{kernel}, {name}.twin counts {twin}")
        ok = n[0] == kernel and twin == 0
        if per is None:
            ok = ok and min(n) > 0
            line += f", the largest of {largest_call(by_rank)} queries"
        elif name == "labelmap":
            a_span = sorted({e["counters"].get("labelmap.kernel", 0)
                             for e in events if e.get("event") == "span"
                             and e["name"] == per})
            line += f", a {per} span counts {a_span}"
            ok = (ok and len(a_span) <= 1 and 0 not in a_span
                  and all(x == n[0] for x in n))
        else:
            want = span_total(events, per)
            line += f", {per} {want}"
            ok = ok and all(x == want for x in n)
        print(f"{tag}: {line}")
        check(ok, f"{tag}: the launches do not match the counts: {line}")


def run_path(torch, workdir, tag, inputs, config_text, warm_runs=0,
             extra=()):
    """One path through the port's CLI on the card, `measured`;
    `warm_runs` more runs in the same process afterwards (tables cached),
    timed and their stage seconds kept. Returns (output prefix, events,
    [the kernels' `tallies`], warm events of the last warm run or None)."""
    from newmsm_tpu_torch import cli

    conf = os.path.join(workdir, f"{tag}.conf")
    with open(conf, "w") as f:
        f.write(config_text)

    def run_cli(prefix):
        metrics = prefix + "metrics.jsonl"
        rc, wall, launches, _ = measured(torch, lambda: cli.main(
            [*inputs, "-o", prefix, "--conf", conf, "--metrics", metrics,
             "--device", "cuda", *extra]))
        check(rc == 0, f"{tag}: cli returned {rc}")
        return wall, [json.loads(line) for line in open(metrics)], launches

    out = os.path.join(workdir, f"{tag}_out_")
    wall, events, launches = run_cli(out)
    print(f"{tag}: cli wall {wall:.2f} s")
    check_kernels(tag, launches, events, "fusion.move")
    warm_events = None
    if warm_runs:
        warm = []
        for i in range(warm_runs):
            w, warm_events, _ = run_cli(os.path.join(workdir,
                                                     f"{tag}_warm{i}_"))
            warm.append(w)
        print(f"{tag}: {warm_runs} more runs in this process: "
              f"{[round(w, 4) for w in warm]} s, median "
              f"{float(np.median(warm)):.4f} s")
    return out, events, launches, warm_events


def print_stages(tag, events):
    """The per-stage seconds of one run's metrics events; returns the
    energies by level."""
    warp = {(e["level"], e["iter"]): e["warp_s"] for e in events
            if e["event"] == "warp"}
    energies = {}
    for e in events:
        if e["event"] == "level":
            print(f"{tag}: level {e['level']} ({e['cost']}): wall "
                  f"{e['wall_s']} s")
        elif e["event"] == "anat_setup":
            print(f"{tag}: level {e['level']} anatomical tables: "
                  f"{e['wall_s']} s")
        elif e["event"] == "outputs":
            print(f"{tag}: outputs written in {e['wall_s']} s")
        elif e["event"] == "iter":
            energies.setdefault(e["level"], []).append(e["energy"])
            extra = ""
            if "sweeps" in e:
                extra = (f" volume {e['volume_s']} s, {e['sweeps']} sweeps x "
                         f"{e['colors']} colours, {e['sweep_s']} s a sweep, "
                         f"start energy {e['energy_start']:.6f}")
            print(f"{tag}: iter level {e['level']} it {e['iter']}: energy "
                  f"{e['energy']:.6f} setup {e['setup_s']} s unary "
                  f"{e['unary_s']} s optimiser {e['fusion_s']} s warp "
                  f"{warp.get((e['level'], e['iter']), 'n/a')} s "
                  f"(cps {e['cps']} labels {e['labels']}){extra}")
    return energies


def check_registration(tag, out, energies, ref_mesh, in_data, ref_data):
    """Outputs exist, finite energies, a fold-free warp, finite transformed
    data of the reference's shape, and a raised sulc CC."""
    from newmsm_tpu_torch.core import io as mio
    from newmsm_tpu_torch.core.mesh import Mesh
    from newmsm_tpu_torch.ops.unfold import count_folds
    flat = [e for es in energies.values() for e in es]
    check(flat and all(np.isfinite(flat)),
          f"{tag}: energies not finite: {flat}")
    for suffix in ("sphere.reg.surf.gii",
                   "transformed_and_reprojected.func.gii"):
        check(os.path.exists(out + suffix), f"{tag}: missing output {suffix}")
    warped = Mesh.load(out + "sphere.reg.surf.gii")
    folds = count_folds(warped, device="cuda")
    transformed = mio.load_data(out + "transformed_and_reprojected.func.gii",
                                ref_mesh)
    check(transformed.shape == ref_data.shape
          and np.isfinite(transformed).all(),
          f"{tag}: transformed data malformed: {transformed.shape}")
    cc_before = _cc(in_data[0], ref_data[0])
    cc_after = _cc(transformed[0], ref_data[0])
    print(f"{tag}: folds {folds}; sulc CC to the reference before "
          f"{cc_before:.4f} after {cc_after:.4f}")
    check(folds == 0, f"{tag}: warped sphere has {folds} folds")
    check(cc_after > cc_before, f"{tag}: the sulc CC was not raised")


def phase_main(torch, workdir, subject, warm_runs=0):
    """The strain path (config_standard_MSM_strain) through the CLI."""
    inputs, template, in_data, template_data = subject
    print(f"main: ico-{template.get_resolution()} subject, "
          f"{template.nvertices} vertices, {in_data.shape[0]} channels")
    print(f"reduced: --it={SMOKE_ITERS} (config_standard_MSM_strain has "
          f"--it={STANDARD_ITERS}); nothing else cut")
    out, events, launches, warm = run_path(torch, workdir, "main", inputs,
                                           STRAIN_CONFIG, warm_runs)
    energies = print_stages("main", events)
    if warm:
        print_stages("main warm", warm)
    n_queries = 0
    first_setup = {}
    last_level = max(e["level"] for e in events if e["event"] == "iter")
    for e in events:
        if e["event"] == "iter":
            if e["level"] == last_level:
                # the largest unary locate call at MAIN_RES: K control
                # points x lchunk(4) labels x pmax patch slots
                n_queries = max(n_queries,
                                e["cps"] * min(4, e["labels"]) * e["pmax"])
            first_setup.setdefault(e["level"], e["setup_s"])
    largest = launches[0]["locate"]["largest"]
    check(n_queries == largest, f"main: the largest locate call had "
          f"{largest} queries, not {n_queries}")
    print("first set-up seconds of each level (cold host table builds): "
          + ", ".join(f"level {lv}: {t}" for lv, t in first_setup.items()))
    check_registration("main", out, energies, template, in_data,
                       template_data)
    return launches, n_queries


def phase_msmpair(torch, workdir, subject, warm_runs=0):
    """This slice's path at full width: config_standard_MSMpair
    (regoption 1) on the ico-6 subject, last level 2,562 control points and
    7,680 pairs."""
    inputs, template, in_data, template_data = subject
    print(f"reduced: --it={SMOKE_ITERS} (config_standard_MSMpair has "
          f"--it={MSMPAIR_STANDARD_ITERS}); nothing else cut")
    out, events, launches, warm = run_path(torch, workdir, "msmpair", inputs,
                                           MSMPAIR_CONFIG, warm_runs)
    energies = print_stages("msmpair", events)
    if warm:
        print_stages("msmpair warm", warm)
    gates = [e for e in events if e["event"] == "fold_gate"]
    for e in gates:
        print(f"msmpair: fold gate level {e['level']} it {e['iter']}: "
              f"{e['gated_entries']} gated entries (share "
              f"{e['gated_fraction']}), chosen on a gated entry "
              f"{e['chosen_gated']}")
    check(len(gates) > 0, "msmpair: no fold_gate event")
    check(all(e["chosen_gated"] == 0 for e in gates),
          "msmpair: a chosen labeling landed on a FOLDING-gated pair")
    check(max(e["cps"] for e in events if e["event"] == "iter") == 2562,
          "msmpair: the last level does not have 2,562 control points")
    check_registration("msmpair", out, energies, template, in_data,
                       template_data)
    return launches


def phase_amsm(torch, workdir, warm_runs=0):
    """The aMSM longitudinal recipe's structure (regoption 5 + triclique)
    on longitudinal_pair(6) with its anatomical meshes."""
    from newmsm_tpu_torch.core import io as mio
    from newmsm_tpu_torch.core.mesh import Mesh
    from newmsm_tpu_torch.eval.synth import longitudinal_pair
    in_mesh, in_data, in_anat, ref_mesh, ref_data, ref_anat = \
        longitudinal_pair(MAIN_RES, seed=0)
    inputs = write_inputs(workdir, "amsm", in_mesh, in_data, ref_mesh,
                          ref_data, anat=(in_anat, ref_anat))
    print("amsm: the STRUCTURE of the reference's aMSM longitudinal recipe "
          "(regoption 5, triclique, CP 2/3/4, data and anatomical grids "
          f"4/5/6, --it={AMSM_ITERS}); NOT the reference's config file "
          "verbatim, which is not in this repository")
    out, events, launches, warm = run_path(torch, workdir, "amsm", inputs,
                                           AMSM_CONFIG, warm_runs)
    energies = print_stages("amsm", events)
    if warm:
        print_stages("amsm warm", warm)
    check_registration("amsm", out, energies, ref_mesh, in_data, ref_data)
    check(os.path.exists(out + "anat.reg.surf.gii"),
          "amsm: missing anat.reg.surf.gii")
    anat_reg = Mesh.load(out + "anat.reg.surf.gii")
    check(anat_reg.coords.shape == in_mesh.coords.shape
          and np.isfinite(anat_reg.coords).all(),
          "amsm: anat.reg.surf.gii malformed")
    strains = mio.load_data(out + "STRAINS.func.gii", in_mesh)
    check(strains.shape == (4, in_mesh.nvertices)
          and np.isfinite(strains).all(),
          f"amsm: STRAINS.func.gii malformed: {strains.shape}")
    r_in = np.linalg.norm(in_anat.coords, axis=1)
    print(f"amsm: anatomical radial CC to the input anatomy before "
          f"{_cc(np.linalg.norm(ref_anat.coords, axis=1), r_in):.4f} after "
          f"{_cc(np.linalg.norm(anat_reg.coords, axis=1), r_in):.4f}; "
          f"STRAINS rows (max stretch, min stretch, Green strains) means "
          f"{[round(float(x), 4) for x in strains.mean(1)]}")
    return launches


def phase_multimodal(torch, workdir):
    """The HCP multimodal recipe's structure (regoption 3 + triclique, the
    multivariate likelihood over 10 channels) on one
    multimodal_cohort(6, 1, n_channels=10) subject against its template."""
    from newmsm_tpu_torch.core import io as mio
    from newmsm_tpu_torch.core.mesh import Mesh
    from newmsm_tpu_torch.eval.synth import multimodal_cohort
    D = MULTIMODAL_CHANNELS
    meshes, datasets, template_data = multimodal_cohort(
        MAIN_RES, 1, n_channels=D, seed=0)
    template = Mesh.from_icosphere(MAIN_RES)
    template.true_rescale(100.0)
    in_data = datasets[0]
    inputs = write_inputs(workdir, "multimodal", meshes[0], in_data,
                          template, template_data)
    print(f"multimodal: ico-{MAIN_RES} subject, {template.nvertices} "
          f"vertices, {D} channels; the STRUCTURE of the reference's HCP "
          "multimodal recipe (regoption 3, triclique, CP 2/3/4, SG and data "
          f"grids 4/5/6, --it={AMSM_ITERS}); NOT the reference's config file "
          "verbatim, which is not in this repository")
    out, events, launches, _ = run_path(torch, workdir, "multimodal", inputs,
                                        MULTIMODAL_CONFIG)
    peak = torch.cuda.max_memory_allocated()      # since `measured` zeroed it
    energies = print_stages("multimodal", events)
    first_setup = {}
    for e in events:
        if e["event"] == "iter":
            first_setup.setdefault(e["level"], e["setup_s"])
    print("multimodal: first set-up seconds of each level: "
          + ", ".join(f"level {lv}: {t}" for lv, t in first_setup.items())
          + f"; peak device memory {peak / 2**30:.3f} GiB")
    check_registration("multimodal", out, energies, template, in_data,
                       template_data)
    transformed = mio.load_data(out + "transformed_and_reprojected.func.gii",
                                template)
    before = [_cc(in_data[c], template_data[c]) for c in range(D)]
    after = [_cc(transformed[c], template_data[c]) for c in range(D)]
    print(f"multimodal: CC to the template by channel before "
          f"{[round(c, 4) for c in before]} after "
          f"{[round(c, 4) for c in after]}; mean {np.mean(before):.4f} -> "
          f"{np.mean(after):.4f}")
    check(np.mean(after) > np.mean(before),
          "multimodal: the mean CC over the channels was not raised")
    lowered = [c for c in range(D) if after[c] < before[c]]
    check(not lowered, f"multimodal: channels {lowered} lost CC")
    return launches


def trace_busy(trace_dir):
    """Of a --profile trace: (events, device kernels, microseconds with a
    kernel on the device (union of the kernel intervals), traced span in
    microseconds)."""
    with open(os.path.join(trace_dir, "trace.json")) as f:
        trace = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in trace
                   if e.get("cat") == "kernel")
    timed = [e for e in trace if "ts" in e and "dur" in e]
    wall = (max(e["ts"] + e["dur"] for e in timed)
            - min(e["ts"] for e in timed))
    busy, end = 0.0, spans[0][0] if spans else 0.0
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return len(trace), len(spans), busy, wall


def phase_mcmc(torch, workdir):
    """One MCMC run at small depth: an ico-5 sphere whose data are the
    analytic group pattern, the input's rotated by 6 degrees. (On a warped
    cohort subject the greedy per-triplet sweep raises the energy from one
    iteration to the next at the second level, in the JAX package as well;
    a rotation is what this optimiser recovers monotonically.)"""
    from newmsm_tpu_torch.core.mesh import Mesh
    from newmsm_tpu_torch.eval.synth import GroupPattern
    sphere = Mesh.from_icosphere(5)
    sphere.true_rescale(100.0)
    unit = sphere.coords / 100.0
    axis = np.array([0.3, 1.0, 0.2]) / np.linalg.norm([0.3, 1.0, 0.2])
    skew = np.cross(np.eye(3), axis)
    ang = np.radians(6.0)
    rot = np.eye(3) + np.sin(ang) * skew + (1 - np.cos(ang)) * skew @ skew
    pattern = GroupPattern(0)
    ref_data, in_data = pattern(unit), pattern(unit @ rot.T)
    inputs = write_inputs(workdir, "mcmc", sphere, in_data, sphere, ref_data)
    out, events, launches, _ = run_path(torch, workdir, "mcmc", inputs,
                                        MCMC_CONFIG)
    energies = print_stages("mcmc", events)
    check_registration("mcmc", out, energies, sphere, in_data, ref_data)
    # each level must end below the energy it began at (every CP at label
    # 0 of its first iteration). From one iteration to the next the energy
    # may rise: the label set alternates, and the sweep judges a triplet by
    # its own cost and a third of its corners' unary costs, not by the
    # other triplets its corners touch
    start = {}
    for e in events:
        if e["event"] == "iter":
            start.setdefault(e["level"], e["energy_start"])
    for level, es in energies.items():
        print(f"mcmc: level {level} energy from {start[level]:.6f} at its "
              f"start to {es[-1]:.6f}; last iteration "
              f"{'not above' if es[-1] <= es[0] else 'ABOVE'} the first")
        check(es[-1] < start[level], f"mcmc: level {level} ended at "
              f"{es[-1]}, not below its start {start[level]}")
    sweeps = [e["sweep_s"] for e in events if e["event"] == "iter"]
    print(f"mcmc: seconds per sweep, by iteration: {sweeps}")

    # the same run once more under --profile: the trace must hold the
    # card's kernels; the share of the traced span with a kernel running
    trace_dir = os.path.join(workdir, "mcmc_trace")
    run_path(torch, workdir, "mcmc_profiled", inputs, MCMC_CONFIG,
             extra=("--profile", trace_dir))
    n_events, n_kernels, busy, wall = trace_busy(trace_dir)
    check(n_kernels > 0, "mcmc: the --profile trace holds no device kernel")
    print(f"mcmc: --profile trace: {n_events} events, {n_kernels} device "
          f"kernels, device busy {busy / wall:.4f} of the traced "
          f"{wall / 1e6:.3f} s")
    return launches


def phase_group(torch, workdir, profile=False):
    """The groupwise path at full width: the gMSM tutorial config on
    GROUP_SUBJECTS ico-6 subjects through the CLI with list files; then
    dedrift on the CLI's output spheres and one small run_gmsm call. With
    `profile`, the config's last level alone (one iteration) runs once more
    under --profile, for the share of the time a kernel is on the card."""
    from newmsm_tpu_torch import cli
    from newmsm_tpu_torch.core import io as mio
    from newmsm_tpu_torch.core.mesh import Mesh
    from newmsm_tpu_torch.eval import metrics
    from newmsm_tpu_torch.eval.synth import synth_cohort
    from newmsm_tpu_torch.ops.unfold import count_folds
    from newmsm_tpu_torch.pipelines import gmsm

    S = GROUP_SUBJECTS
    meshes, datasets, _ = synth_cohort(MAIN_RES, S, seed=0)
    template = Mesh.from_icosphere(MAIN_RES)
    template.true_rescale(100.0)
    print(f"group: {S} ico-{MAIN_RES} subjects, {template.nvertices} "
          f"vertices, {datasets[0].shape[0]} channels; template ico-"
          f"{MAIN_RES}")
    print(f"reduced: --it={GROUP_ITERS} (the gMSM tutorial config has "
          f"--it={GROUP_STANDARD_ITERS}); nothing else cut")
    mesh_paths, data_paths = [], []
    for s in range(S):
        mesh_paths.append(os.path.join(workdir, f"group_{s}.surf.gii"))
        data_paths.append(os.path.join(workdir, f"group_{s}.func.gii"))
        meshes[s].save(mesh_paths[-1])
        Mesh(coords=meshes[s].coords, faces=meshes[s].faces,
             data=datasets[s]).save(data_paths[-1])
    lists = {}
    for name, paths in (("meshes", mesh_paths), ("data", data_paths)):
        lists[name] = os.path.join(workdir, f"group_{name}.txt")
        with open(lists[name], "w") as f:
            f.write("\n".join(paths) + "\n")
    tmpl_path = os.path.join(workdir, "group_template.surf.gii")
    template.save(tmpl_path)
    conf = os.path.join(workdir, "group.conf")
    with open(conf, "w") as f:
        f.write(GROUP_CONFIG)
    out = os.path.join(workdir, "group_out_")
    metrics_path = out + "metrics.jsonl"

    rc, wall, launches, peak = measured(torch, lambda: cli.main(
        ["--groupwise", "--meshes", lists["meshes"], "--data", lists["data"],
         "--template", tmpl_path, "-o", out, "--conf", conf, "--metrics",
         metrics_path, "--device", "cuda"]))
    check(rc == 0, f"group: cli returned {rc}")
    print(f"group: cli wall {wall:.2f} s, peak device memory "
          f"{peak / 2**30:.3f} GiB")

    events = [json.loads(line) for line in open(metrics_path)]
    check_kernels("group", launches, events, "group.alpha")
    iters = [e for e in events if e["event"] == "iter"]
    warp = {(e["level"], e["iter"]): e["warp_s"] for e in events
            if e["event"] == "warp"}
    for e in events:
        if e["event"] == "level":
            print(f"group: level {e['level']}: wall {e['wall_s']} s, of which "
                  f"level set-up {e['init_s']} s")
        elif e["event"] == "outputs":
            print(f"group: outputs written in {e['wall_s']} s")
        elif e["event"] == "iter":
            print(f"group: iter level {e['level']} it {e['iter']}: energy "
                  f"{e['energy']:.6f} setup_s {e['setup_s']} opt_s "
                  f"{e['opt_s']} warp_s "
                  f"{warp.get((e['level'], e['iter']), 'n/a')} (changed "
                  f"{e['changed']:.3f}, pmax {e['pmax']}, patch_overflow "
                  f"{e['patch_overflow']}, colours {e['colors']}, pair-block "
                  f"batches {e['pair_chunks_by_rank'][0]} of "
                  f"{e['pair_chunk_blocks']})")
    check(len(iters) > 0 and all(np.isfinite(e["energy"]) for e in iters),
          "group: energies not finite")
    levels = sorted({e["level"] for e in iters})
    check(levels == [1, 2, 3], f"group: levels run: {levels}")
    for lv in levels:
        last = [e for e in iters if e["level"] == lv][-1]
        check(last["patch_overflow"] == 0, f"group: level {lv} ended with "
              f"patch_overflow {last['patch_overflow']}")

    spheres, maps, folds = [], [], []
    for s in range(S):
        sp = out + f"sphere-{s}.reg.surf.gii"
        dp = out + f"transformed_and_reprojected-{s}.func.gii"
        check(os.path.exists(sp) and os.path.exists(dp),
              f"group: missing outputs of subject {s}")
        spheres.append(Mesh.load(sp))
        folds.append(count_folds(spheres[-1], device="cuda"))
        data = mio.load_data(dp, template)
        check(data.shape == datasets[s].shape and np.isfinite(data).all(),
              f"group: transformed data of subject {s} malformed")
        maps.append(data)
    cc_before = metrics.mean_pairwise_cc([d[0] for d in datasets])
    cc_after = metrics.mean_pairwise_cc([d[0] for d in maps])
    print(f"group: folds by subject {folds}; mean pairwise sulc CC before "
          f"{cc_before:.4f} after {cc_after:.4f}")
    check(sum(folds) == 0, f"group: output spheres have folds: {folds}")
    check(cc_after > cc_before, "group: the mean pairwise CC was not raised")

    if profile:
        pconf = os.path.join(workdir, "group_profile.conf")
        with open(pconf, "w") as f:
            f.write(GROUP_LAST_LEVEL_CONFIG)
        trace_dir = os.path.join(workdir, "group_trace")
        pout = os.path.join(workdir, "group_profiled_")
        rc, pwall, _, _ = measured(torch, lambda: cli.main(
            ["--groupwise", "--meshes", lists["meshes"], "--data",
             lists["data"], "--template", tmpl_path, "-o", pout, "--conf",
             pconf, "--metrics", pout + "metrics.jsonl", "--device", "cuda",
             "--profile", trace_dir]))
        check(rc == 0, f"group: profiled cli returned {rc}")
        n_events, n_kernels, busy, span = trace_busy(trace_dir)
        check(n_kernels > 0, "group: the --profile trace holds no kernel")
        pe = [json.loads(line) for line in open(pout + "metrics.jsonl")]
        it = [e for e in pe if e["event"] == "iter"][0]
        print(f"group: last level alone (K 2,562, one iteration) under "
              f"--profile: cli wall {pwall:.2f} s, setup_s {it['setup_s']} "
              f"opt_s {it['opt_s']}; trace of {n_events} events, {n_kernels} "
              f"device kernels, device busy {busy / span:.4f} of the traced "
              f"{span / 1e6:.3f} s")

    # dedrift on the CLI's output spheres: the common (mean) displacement
    # must shrink, and the spheres stay fold-free
    def drift(ms):
        mean_disp = np.mean([m.coords - meshes[0].coords for m in ms], axis=0)
        return float(np.sqrt((mean_disp ** 2).sum(1).mean()))

    ded, ded_s, _, _ = measured(torch, lambda: gmsm.dedrift(
        spheres, meshes[0], device="cuda"))
    ded_folds = [count_folds(m, device="cuda") for m in ded]
    print(f"group: dedrift of {S} spheres in {ded_s:.2f} s: rms mean "
          f"displacement {drift(spheres):.4f} -> {drift(ded):.4f}; folds "
          f"{ded_folds}")
    check(drift(ded) < drift(spheres), "group: dedrift did not shrink the "
          "mean displacement")
    check(sum(ded_folds) == 0, f"group: dedrifted spheres fold: {ded_folds}")

    # one run_gmsm call at small depth
    sm, sd, _ = synth_cohort(4, 3, seed=0)
    small_t = Mesh.from_icosphere(4)
    small_t.true_rescale(100.0)
    sconf = os.path.join(workdir, "group_small.conf")
    with open(sconf, "w") as f:
        f.write(GROUP_SMALL_CONFIG)
    gout = os.path.join(workdir, "gmsm_out_")
    res, small_s, _, _ = measured(torch, lambda: gmsm.run_gmsm(
        sm, sd, small_t, sconf, outdir=gout, device="cuda"))
    print(f"group: run_gmsm (3 subjects, ico-4, --it={GROUP_ITERS}) in "
          f"{small_s:.2f} s: stats "
          f"{ {k: round(v, 4) for k, v in res.stats.items()} }")
    want = {"cc", "dice", "areal_mean", "areal_max", "areal_95", "areal_98",
            "shape_mean", "shape_max"}
    check(want <= set(res.stats) and all(
        np.isfinite(v) for v in res.stats.values()),
        f"group: run_gmsm stats malformed: {res.stats}")
    for name in ("mean.func.gii", "stdev.func.gii"):
        check(os.path.exists(gout + name), f"group: run_gmsm wrote no {name}")
    check(res.mean_map.shape == (2, small_t.nvertices)
          and np.isfinite(res.mean_map).all(), "group: mean map malformed")
    check(res.stats["cc"] > metrics.mean_pairwise_cc([d[0] for d in sd]),
          "group: run_gmsm did not raise the mean pairwise CC")
    run = dict(lists=lists, tmpl=tmpl_path, conf=conf, S=S, template=template,
               energies=[e["energy"] for e in iters],
               levels=[e["level"] for e in iters],
               spheres=[m.coords for m in spheres], maps=maps)
    return launches, run


def _first_levels(config: str, n: int) -> str:
    """The config with every per-level list cut to its first n levels."""
    out = []
    for line in config.splitlines():
        key, eq, vals = line.partition("=")
        out.append(key + eq + ",".join(vals.split(",")[:n]) if "," in vals
                   else line)
    return "\n".join(out) + "\n"


def run_ranks_cmd(cmd, timeout):
    """Run a command that starts rank processes in a process group of its
    own; on the time limit the whole group is killed, ranks included.
    Returns (returncode, stdout, stderr)."""
    import signal
    env = dict(os.environ, OMP_NUM_THREADS="4",
               PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(cmd, cwd=HERE, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            process_group=0)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        return 124, out, err
    return proc.returncode, out, err


def _torchrun_group(workdir, ref, tag, backend):
    """phase_group's CLI call under torchrun, 2 ranks on --device cuda with
    `backend`; checks energies, devices and spheres against phase_group
    bitwise. Returns the ranks' launches of K1 and K2 (the tallies its
    `ranks` event reports) and the level walls."""
    from newmsm_tpu_torch.core import io as mio
    from newmsm_tpu_torch.core.mesh import Mesh
    out = os.path.join(workdir, f"{tag}_out_")
    metrics_path = out + "metrics.jsonl"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=2", "-m", "newmsm_tpu_torch.cli", "--groupwise",
           "--meshes", ref["lists"]["meshes"], "--data", ref["lists"]["data"],
           "--template", ref["tmpl"], "-o", out, "--conf", ref["conf"],
           "--metrics", metrics_path, "--device", "cuda", "--dist-backend",
           backend]
    t0 = time.perf_counter()
    rc, stdout, stderr = run_ranks_cmd(cmd, timeout=600)
    wall = time.perf_counter() - t0
    check(rc == 0, f"{tag}: torchrun returned {rc}\n{stdout[-2000:]}\n"
                   f"{stderr[-6000:]}")
    events = [json.loads(line) for line in open(metrics_path)]
    iters = [e for e in events if e["event"] == "iter"]
    ranks = [e for e in events if e["event"] == "ranks"]
    check(len(ranks) == 1, f"{tag}: {len(ranks)} ranks events, not 1")
    ranks = ranks[0]
    print(f"{tag}: torchrun, 2 ranks on --device cuda --dist-backend "
          f"{backend}: wall {wall:.2f} s (rank start-up included)")
    for e in events:
        if e["event"] == "level":
            print(f"{tag}: level {e['level']}: wall {e['wall_s']} s, of "
                  f"which level set-up {e['init_s']} s")
        elif e["event"] == "iter":
            print(f"{tag}: iter level {e['level']} it {e['iter']}: energy "
                  f"{e['energy']:.6f} devices {e['devices']} maps_exchange "
                  f"{e['maps_exchange']} setup_s by rank "
                  f"{e['setup_s_by_rank']} opt_s by rank {e['opt_s_by_rank']}")
    print(f"{tag}: peak device memory by rank "
          f"{[round(b / 2**30, 3) for b in ranks['peak_device_bytes']]} GiB")
    check(all(e["devices"] == 2 for e in iters),
          f"{tag}: an iter event does not read devices 2")
    launches = [{"locate": {"kernel": n, "largest": q}, "icm": {"kernel": m},
                 "labelmap": {"kernel": f}}
                for n, q, m, f in zip(ranks["locate_launches"],
                                      ranks["locate_largest"],
                                      ranks["icm_launches"],
                                      ranks["labelmap_launches"])]
    check_kernels(tag, launches, events, "group.alpha")
    energies = [e["energy"] for e in iters]
    same_e = energies == ref["energies"]
    same_s = [np.array_equal(Mesh.load(out + f"sphere-{s}.reg.surf.gii")
                             .coords, ref["spheres"][s])
              for s in range(ref["S"])]
    same_m = [np.array_equal(mio.load_data(
        out + f"transformed_and_reprojected-{s}.func.gii", ref["template"]),
        ref["maps"][s]) for s in range(ref["S"])]
    print(f"{tag}: energies bitwise those of phase group: {same_e}; "
          f"spheres bitwise equal by subject {same_s}; transformed maps "
          f"bitwise equal by subject {same_m}")
    check(same_e, f"{tag}: energies {energies} differ from phase group's "
                  f"{ref['energies']}")
    check(all(same_s), f"{tag}: output spheres differ from phase group's")
    check(all(same_m), f"{tag}: transformed maps differ from phase group's")
    walls = [e["wall_s"] for e in events if e["event"] == "level"]
    return launches, walls


def _group_ring_rank(lists, tmpl_path, conf, out, device="cuda"):
    """One rank of phase_group_sharded's ring run (spawned): the group
    driver with maps_exchange 'ring' on this rank's device."""
    import torch
    import torch.distributed as dist
    from newmsm_tpu_torch.cli import read_list_file
    from newmsm_tpu_torch.parallel import multihost as mh
    from newmsm_tpu_torch.reg.group import GroupMeshRegistration
    g = GroupMeshRegistration(device=mh.rank_device(device),
                              group=dist.group.WORLD)
    g.maps_exchange = "ring"
    g.outdir = out
    g.metrics_path = out + "metrics.jsonl"
    g.set_inputs(read_list_file(lists["meshes"]))
    g.set_data_list(read_list_file(lists["data"]))
    g.set_template(tmpl_path)
    g.run_multiresolutions(conf)
    cuda = g.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    return dict(energies=[e for _, _, e in g.energy_log],
                levels=[lv for lv, _, _ in g.energy_log],
                exchange=g._maps_exchange_used, world=g.comm.world,
                tallies=tallies(),
                peak=torch.cuda.max_memory_allocated() if cuda else -1)


def phase_group_sharded(torch, workdir, ref):
    """The subject-sharded group path on phase_group's inputs and config:
    (a) the CLI under torchrun, 2 ranks sharing the card under gloo; (b)
    the ring maps exchange at 2 ranks, spawned from here, on the config's
    first two levels; (c) (a) under NCCL, one card a rank, when there are
    two cards. Each must reproduce phase_group bitwise. The ranks share one
    card in (a) and (b): a correctness run, not a scaling one."""
    from newmsm_tpu_torch.parallel import multihost as mh
    t0 = time.perf_counter()
    by_path = {}
    by_path["group_sharded"], gather_walls = _torchrun_group(
        workdir, ref, "group_sharded", "gloo")
    conf2 = os.path.join(workdir, "group_two_levels.conf")
    with open(conf2, "w") as f:
        f.write(_first_levels(GROUP_CONFIG, 2))
    t1 = time.perf_counter()
    ring_out = os.path.join(workdir, "group_ring_out_")
    ring = mh.run_local_ranks(
        _group_ring_rank, 2, backend="gloo", timeout=600,
        args=(ref["lists"], ref["tmpl"], conf2, ring_out))
    ring_events = [json.loads(line) for line in open(ring_out
                                                      + "metrics.jsonl")]
    ring_walls = [e["wall_s"] for e in ring_events if e["event"] == "level"]
    print(f"group_ring: level walls, levels 1-2, W = 2 on the one card: "
          f"ring {ring_walls} s, gather (the torchrun run above) "
          f"{gather_walls[:2]} s")
    want = [e for e, lv in zip(ref["energies"], ref["levels"]) if lv <= 2]
    print(f"group_ring: 2 ranks, maps_exchange "
          f"{[r['exchange'] for r in ring]}, levels 1-2 of the config: wall "
          f"{time.perf_counter() - t1:.2f} s (spawn included); peak device "
          f"memory by rank {[round(r['peak'] / 2**30, 3) for r in ring]} "
          f"GiB; energies bitwise those of phase group's levels 1-2: "
          f"{[r['energies'] == want for r in ring]}")
    check(all(r["exchange"] == "ring" and r["world"] == 2 for r in ring),
          "group_ring: not a 2-rank ring run")
    check(all(r["energies"] == want for r in ring),
          f"group_ring: energies {[r['energies'] for r in ring]} differ "
          f"from phase group's levels 1-2 {want}")
    by_path["group_ring"] = [r["tallies"] for r in ring]
    check_kernels("group_ring", by_path["group_ring"], ring_events,
                  "group.alpha")
    if torch.cuda.device_count() >= 2:
        by_path["group_sharded_nccl"], _ = _torchrun_group(
            workdir, ref, "group_sharded_nccl", "nccl")
    else:
        print("group_sharded_nccl: not run: this machine has "
              f"{torch.cuda.device_count()} card, and NCCL refuses two ranks "
              "on one card")
    print(f"group_sharded: phase wall {time.perf_counter() - t0:.2f} s")
    return by_path


def _gmsm_summary(res):
    """What phase_gmsm_ranks holds bitwise: a GMSMResult as numpy."""
    return dict(energies=res.energies, stats=res.stats, mean=res.mean_map,
                stdev=res.stdev_map,
                spheres=[m.coords for m in res.dedrifted_spheres])


def _gmsm_rank(meshes, datasets, template, conf, metrics_path):
    """One rank of phase_gmsm_ranks (spawned): run_gmsm over the world on
    this rank's card; its summary, launches, wall and peak memory."""
    import torch
    import torch.distributed as dist
    from newmsm_tpu_torch.parallel import multihost as mh
    from newmsm_tpu_torch.pipelines import gmsm
    dev = mh.rank_device("cuda")
    t0 = time.perf_counter()
    res = gmsm.run_gmsm(meshes, datasets, template, conf, device=dev,
                        group=dist.group.WORLD, metrics_path=metrics_path)
    torch.cuda.synchronize(dev)
    return dict(_gmsm_summary(res), wall=time.perf_counter() - t0,
                tallies=tallies(),
                peak=torch.cuda.max_memory_allocated(dev), device=str(dev))


def _same_gmsm(got, want) -> dict:
    """Which parts of two _gmsm_summary dicts are bitwise equal."""
    return dict(
        energies=got["energies"] == want["energies"],
        stats=got["stats"] == want["stats"],
        mean=np.array_equal(got["mean"], want["mean"]),
        stdev=np.array_equal(got["stdev"], want["stdev"]),
        spheres=all(np.array_equal(a, b) for a, b in
                    zip(got["spheres"], want["spheres"])))


def _print_gmsm_iters(tag, metrics_path):
    """The per-iteration lines of a run_gmsm metrics file; returns (the
    iter events, all events)."""
    events = [json.loads(line) for line in open(metrics_path)]
    iters = [e for e in events if e["event"] == "iter"]
    for e in iters:
        print(f"{tag}: iter level {e['level']} it {e['iter']}: energy "
              f"{e['energy']:.6f} setup_s by rank {e['setup_s_by_rank']} "
              f"opt_s by rank {e['opt_s_by_rank']} (pmax {e['pmax']}, "
              f"patch_overflow {e['patch_overflow']}, pair-block batches by "
              f"rank {e['pair_chunks_by_rank']} of "
              f"{e['pair_chunk_blocks']} blocks)")
    for e in events:
        if e["event"] == "level":
            print(f"{tag}: level {e['level']}: wall {e['wall_s']} s, of which "
                  f"level set-up {e['init_s']} s")
    return iters, events


def phase_gmsm_ranks(torch, workdir):
    """run_gmsm on GMSM_SUBJECTS ico-6 subjects with phase_group's config:
    one rank in this process, then 2 spawned ranks (gloo on the one card;
    NCCL too when there are two cards), each bitwise the one-rank run."""
    from newmsm_tpu_torch.core.mesh import Mesh
    from newmsm_tpu_torch.eval import metrics
    from newmsm_tpu_torch.eval.synth import synth_cohort
    from newmsm_tpu_torch.ops.unfold import count_folds
    from newmsm_tpu_torch.parallel import group_fusion as GF
    from newmsm_tpu_torch.parallel import multihost as mh
    from newmsm_tpu_torch.pipelines import gmsm

    S = GMSM_SUBJECTS
    t_phase = time.perf_counter()
    meshes, datasets, _ = synth_cohort(MAIN_RES, S, seed=0)
    template = Mesh.from_icosphere(MAIN_RES)
    template.true_rescale(100.0)
    conf = os.path.join(workdir, "gmsm_ranks.conf")
    with open(conf, "w") as f:
        f.write(GROUP_CONFIG)
    print(f"gmsm_ranks: run_gmsm on {S} ico-{MAIN_RES} subjects "
          f"(synth_cohort({MAIN_RES}, {S}, seed=0), sulc + curv), ico-"
          f"{MAIN_RES} template, {len(GF.pair_blocks(S))} pair blocks; "
          f"reduced: --it={GROUP_ITERS} (the gMSM tutorial config has "
          f"--it={GROUP_STANDARD_ITERS}); nothing else cut")

    one_metrics = os.path.join(workdir, "gmsm_one_metrics.jsonl")
    res, wall, launches, peak = measured(torch, lambda: gmsm.run_gmsm(
        meshes, datasets, template, conf, device="cuda",
        metrics_path=one_metrics))
    one = _gmsm_summary(res)
    print(f"gmsm_ranks: one rank: wall {wall:.2f} s, peak device memory "
          f"{peak / 2**30:.3f} GiB")
    iters, one_events = _print_gmsm_iters("gmsm_ranks one rank", one_metrics)
    check_kernels("gmsm_ranks one rank", launches, one_events, "group.alpha")
    check(all(np.isfinite(e["energy"]) for e in iters),
          "gmsm_ranks: energies not finite")
    levels = sorted({e["level"] for e in iters})
    check(levels == [1, 2, 3], f"gmsm_ranks: levels run: {levels}")
    chunks = {}
    for lv in levels:
        at = [e for e in iters if e["level"] == lv]
        check(at[-1]["patch_overflow"] == 0, f"gmsm_ranks: level {lv} ended "
              f"with patch_overflow {at[-1]['patch_overflow']}")
        chunks[lv] = sorted({e["pair_chunks_by_rank"][0] for e in at})
    print(f"gmsm_ranks: pair-block batches a table build on one rank, by "
          f"level: {chunks} (more than one: the chunked branch)")
    check(max(max(c) for c in chunks.values()) > 1,
          "gmsm_ranks: the pair blocks never went in more than one batch")
    folds = [count_folds(m, device="cuda") for m in res.dedrifted_spheres]
    cc_before = metrics.mean_pairwise_cc([d[0] for d in datasets])
    print(f"gmsm_ranks: folds of the dedrifted spheres {folds}; mean "
          f"pairwise sulc CC before {cc_before:.4f} after "
          f"{res.stats['cc']:.4f}; stats "
          f"{ {k: round(v, 4) for k, v in res.stats.items()} }")
    check(sum(folds) == 0, f"gmsm_ranks: dedrifted spheres fold: {folds}")
    check(res.stats["cc"] > cc_before,
          "gmsm_ranks: the mean pairwise CC was not raised")
    by_path = {"gmsm": launches}

    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 2
                           else [])
    for backend in backends:
        tag = f"gmsm_ranks_{backend}"
        rank_metrics = os.path.join(workdir, f"{tag}_metrics.jsonl")
        t0 = time.perf_counter()
        ranks = mh.run_local_ranks(
            _gmsm_rank, 2, backend=backend, timeout=900,
            args=(meshes, datasets, template, conf, rank_metrics))
        print(f"{tag}: 2 ranks on {[r['device'] for r in ranks]}: wall "
              f"{time.perf_counter() - t0:.2f} s with the spawn, run_gmsm "
              f"{[round(r['wall'], 2) for r in ranks]} s by rank; peak device "
              f"memory by rank {[round(r['peak'] / 2**30, 3) for r in ranks]}"
              f" GiB")
        rank_iters, rank_events = _print_gmsm_iters(tag, rank_metrics)
        by_path[tag] = [r["tallies"] for r in ranks]
        check_kernels(tag, by_path[tag], rank_events, "group.alpha")
        check(all(e["devices"] == 2 for e in rank_iters),
              f"{tag}: an iter event does not read devices 2")
        for r, got in enumerate(ranks):
            same = _same_gmsm(got, one)
            print(f"{tag}: rank {r} bitwise equal to the one-rank run: "
                  f"{same}")
            check(all(same.values()), f"{tag}: rank {r} differs from the "
                                      f"one-rank run: {same}")
        for name in ("locate", "labelmap"):
            total = launched(by_path[tag], name)
            one_rank = launched(launches, name)
            check(total == one_rank, f"{tag}: {total} {name} launches over "
                                     f"the ranks, {one_rank} on one rank")
    if len(backends) == 1:
        print("gmsm_ranks_nccl: not run: this machine has "
              f"{torch.cuda.device_count()} card, and NCCL refuses two ranks "
              "on one card")
    print(f"gmsm_ranks: phase wall {time.perf_counter() - t_phase:.2f} s")
    return by_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warm-runs", type=int, default=0,
                    help="after the strain, MSMpair and aMSM paths, time "
                         "this many more runs of each in the same process "
                         "(tables cached)")
    ap.add_argument("--profile-group", action="store_true",
                    help="after the group path, run its last level alone "
                         "(one iteration) under --profile and print the "
                         "share of the time a kernel is on the card")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import newmsm_tpu_torch  # noqa: F401  (fails outside the repo)
    from newmsm_tpu_torch.core.mesh import Mesh
    from newmsm_tpu_torch.eval.synth import synth_cohort

    phase_device(torch)
    phase_build()
    max_err = phase_kernel(torch)
    by_path = {}
    with tempfile.TemporaryDirectory() as workdir:
        meshes, datasets, template_data = synth_cohort(MAIN_RES, 1, seed=0)
        template = Mesh.from_icosphere(MAIN_RES)
        template.true_rescale(100.0)
        subject = (write_inputs(workdir, "subject", meshes[0], datasets[0],
                                template, template_data),
                   template, datasets[0], template_data)
        by_path["strain"], n_queries = phase_main(torch, workdir, subject,
                                                  args.warm_runs)
        by_path["msmpair"] = phase_msmpair(torch, workdir, subject,
                                           args.warm_runs)
        by_path["amsm"] = phase_amsm(torch, workdir, args.warm_runs)
        by_path["multimodal"] = phase_multimodal(torch, workdir)
        by_path["mcmc"] = phase_mcmc(torch, workdir)
        by_path["group"], group_run = phase_group(torch, workdir,
                                                  args.profile_group)
        by_path.update(phase_group_sharded(torch, workdir, group_run))
        by_path.update(phase_gmsm_ranks(torch, workdir))
    k, plain, roof = phase_timing(torch, n_queries, MAIN_RES)
    # and at the largest call of the new paths (triclique / anatomical)
    largest = max(largest_call(r) for r in by_path.values())
    kl, plainl, roofl = phase_timing(torch, largest, MAIN_RES)
    # each kernel's launches by path, summed over the ranks (the group
    # paths' ranks events do not report K3)
    launches = {name: {p: launched(r, name) for p, r in by_path.items()
                       if name in r[0]}
                for name in ("locate", "icm", "rigid", "labelmap")}
    # K2 runs on every path with a DISCRETE level; MCMC bypasses it
    for path, n in launches["icm"].items():
        check((n == 0) if path == "mcmc" else (n > 0),
              f"{path}: {n} icm_binary launches")
    icm_times = phase_icm_timing()
    # K3 runs on the paths with an AFFINE level, and on no other
    for path, n in launches["rigid"].items():
        check((n > 0) == (path in ("strain", "msmpair")),
              f"{path}: {n} rigid_cost launches")
    rigid_times = phase_rigid_timing()
    # K4 runs on the group paths, and on no other
    for path, n in launches["labelmap"].items():
        check((n > 0) == path.startswith(("group", "gmsm")),
              f"{path}: {n} label_forward launches")
    labelmap_times = phase_labelmap_timing()
    # library_ms: no single PyTorch call computes point location on a
    # subdivision tree plus barycentric weights
    print(json.dumps({"kernels": [{
        "name": "locate_bary", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": sum(launches["locate"].values()),
        "launches_by_path": launches["locate"],
        "largest_call_by_path": {p: largest_call(r)
                                 for p, r in by_path.items()},
        "max_abs_err": max_err, "ms": k["ms"], "plain_ms": plain["ms"],
        "bound_ms": roof["bound_ms"], "bound_by": roof["bound_by"],
        "library_ms": None, "ms_spread": k["ms_spread"],
        "queries": n_queries, "largest_call": {
            "queries": largest, "ms": kl["ms"], "plain_ms": plainl["ms"],
            "bound_ms": roofl["bound_ms"], "bound_by": roofl["bound_by"]}}, {
        "name": "icm_binary", "route": "cuda",
        "source": "newmsm_tpu_torch/csrc/icm_binary.cu", "replaces": None,
        "launches": sum(launches["icm"].values()),
        "launches_by_path": launches["icm"],
        "bound_by": "the passes x colours chain of cluster barriers",
        "library_ms": None, **icm_times}, {
        "name": "rigid_cost", "route": "cuda",
        "source": "newmsm_tpu_torch/csrc/rigid_cost.cu", "replaces": None,
        "launches": sum(launches["rigid"].values()),
        "launches_by_path": launches["rigid"], "library_ms": None,
        **rigid_times}, {
        "name": "label_forward", "route": "cuda",
        "source": "newmsm_tpu_torch/csrc/label_forward.cu", "replaces": None,
        "launches": sum(launches["labelmap"].values()),
        "launches_by_path": launches["labelmap"], "bound_by": "operations",
        "library_ms": None, **labelmap_times}]}))
    print(f"chip_smoke: whole script {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
