#!/usr/bin/env python3
"""Smoke run of the PyTorch port (newmsm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--warm-runs N]

Phases, each printing its own lines; any failure exits non-zero and prints
no result line:

  1. device   require CUDA; print the card's name and power limit
              (nvidia-smi) and the torch / CUDA versions;
  2. build    compile the locate kernel (csrc/locate_bary.cu) with nvcc;
              print its ptxas line (registers, spills) and resident grid;
  3. kernel   the kernel against its plain PyTorch version on the card:
              2^20 random directions plus every vertex of ico-res, res in
              {0,2,4,6}; row sums, reconstructed positions, vertex mass and
              face-id agreement;
  4. main     the pairwise strain-registration path through the CLI
              (config_standard_MSM_strain, --it cut to 10,3,3,3) on an ico-6
              synthetic subject; checks outputs, folds, the sulc CC gain and
              that the path went through the kernel; prints the first
              set-up seconds of each level (the cold host table builds);
  5. timing   the kernel and its plain version at the shape of the main
              path's largest locate call: windows of back-to-back launches
              between CUDA events (median and spread), the SM clock and
              power sampled under the load, the roofline bound and the
              issue-slot bound from the SASS instruction count.

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
    from newmsm_tpu_torch.ops import _build, locate
    t0 = time.perf_counter()
    locate._library()
    print(f"build: {locate.SOURCE} ready (nvcc at first use) in "
          f"{time.perf_counter() - t0:.2f} s")
    name = f"{locate.KERNEL}ILi{MAIN_RES}E"
    print(f"build: ptxas, res {MAIN_RES} kernel: "
          f"{_build.ptxas_usage(locate.SOURCE, name)}")
    print(f"build: grid capped at {locate.resident_blocks(MAIN_RES, 'cuda')} "
          f"resident blocks (occupancy x SMs)")


def phase_kernel(torch):
    """K1 against its plain version on the card (tolerances of the JAX
    package's on-device probe, pallas_locate.py:149-158)."""
    from newmsm_tpu_torch.core.icosphere import icosphere
    from newmsm_tpu_torch.ops import locate

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
        px, py, pz = (q[:, i].contiguous() for i in range(3))
        fid_k, *wk = locate.locate_bary(px, py, pz, res)
        fid_p, *wp = locate.locate_bary_reference(px, py, pz, res)
        torch.cuda.synchronize()
        Wk = torch.stack(wk, 1).double().cpu().numpy()
        Wp = torch.stack(wp, 1).double().cpu().numpy()
        fk = fid_k.cpu().numpy()
        fp = fid_p.cpu().numpy()
        faces = ico.faces
        pos_k = (ico.coords[faces[fk]] * Wk[..., None]).sum(1)
        pos_p = (ico.coords[faces[fp]] * Wp[..., None]).sum(1)
        pos_err = float(np.abs(pos_k - pos_p).max())
        row_err = float(np.abs(Wk.sum(1) - 1.0).max())
        wmin = float(Wk.min())
        mism = fk[:n_rand] != fp[:n_rand]
        same = fk == fp
        w_err = float(np.abs(Wk[same] - Wp[same]).max())
        vid = np.arange(ico.nvertices)
        hit = faces[fk[n_rand:]] == vid[:, None]
        vmass = float(np.abs(Wk[n_rand:][hit] - 1.0).max()) if hit.any() \
            else 1.0
        print(f"kernel res {res}: queries {q.shape[0]} fid_mismatch "
              f"{int(mism.sum())}/{n_rand} pos_err {pos_err:.3e} "
              f"row_err {row_err:.3e} min_w {wmin:.3e} "
              f"w_err_same_face {w_err:.3e} vertex_mass_err {vmass:.3e}")
        # tolerances of the JAX package's on-device probe: row sums 1e-4,
        # positions 2e-4 (unit sphere), weights >= -1e-4, vertex mass 1e-3;
        # face-id mismatches (boundary ties) at most 1e-4 of random queries
        check(row_err < 1e-4, f"res {res}: row sums off by {row_err}")
        check(pos_err < 2e-4, f"res {res}: position error {pos_err}")
        check(wmin >= -1e-4, f"res {res}: negative weight {wmin}")
        check(bool(hit.any(axis=1).all()),
              f"res {res}: a vertex query landed on a non-incident face")
        check(vmass < 1e-3, f"res {res}: vertex mass error {vmass}")
        check(mism.sum() <= 1e-4 * n_rand,
              f"res {res}: {int(mism.sum())} face-id mismatches")
        worst_pos = max(worst_pos, pos_err)

    return worst_pos


def phase_timing(torch, n_queries: int, res: int):
    """Times of the kernel (windows of 200 launches after 50 warm-ups) and
    of its plain version (windows of 5) on one locate call of the main
    path's shape, beside the roofline and issue-slot bounds."""
    from newmsm_tpu_torch.ops import locate, locate_bench as lb
    dev = torch.device("cuda", torch.cuda.current_device())
    px, py, pz = lb.random_queries(n_queries, dev)
    fn = locate._library().locate_bary_launch
    tables = locate.kernel_tables(dev)
    fid = torch.empty(n_queries, dtype=torch.int32, device=dev)
    w0, w1, w2 = (torch.empty_like(px) for _ in range(3))
    k = lb.time_launches(lambda: locate.launch(fn, px, py, pz, res, tables,
                                               fid, w0, w1, w2))
    plain = lb.time_launches(
        lambda: locate.locate_bary_reference(px, py, pz, res), windows=3,
        launches=5, warmup=2)
    static = lb.static_profile(locate.SOURCE, res, n_queries, k)
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
    check(static["issue_slot_ms"] is not None,
          "no SM clock sample was taken under the kernel load")
    print(f"issue-slot bound: {static['sass_instructions']} SASS "
          f"instructions a query at {static['sm_mhz']:.0f} MHz -> "
          f"{static['issue_slot_ms']:.5f} ms, share "
          f"{static['issue_slot_ms'] / k['ms']:.3f}")
    print(f"SASS by opcode: {static['sass_opcodes']}")
    return k, plain, roof


def _cc(a, b) -> float:
    return float(np.corrcoef(a, b)[0, 1])


def phase_main(torch, workdir, warm_runs=0):
    """The port's main path through its CLI on the card; `warm_runs` more
    runs in the same process afterwards, timed only."""
    from newmsm_tpu_torch import cli
    from newmsm_tpu_torch.core import io as mio
    from newmsm_tpu_torch.core.mesh import Mesh
    from newmsm_tpu_torch.eval.synth import synth_cohort
    from newmsm_tpu_torch.ops import locate
    from newmsm_tpu_torch.ops.unfold import count_folds

    t0 = time.perf_counter()
    meshes, datasets, template_data = synth_cohort(6, 1, seed=0)
    template = Mesh.from_icosphere(6)
    template.true_rescale(100.0)
    paths = {}
    for name, mesh, data in (("in", meshes[0], datasets[0]),
                             ("ref", template, template_data)):
        paths[name] = (os.path.join(workdir, f"{name}.surf.gii"),
                       os.path.join(workdir, f"{name}.func.gii"))
        mesh.save(paths[name][0])
        Mesh(coords=mesh.coords, faces=mesh.faces, data=data).save(
            paths[name][1])
    conf = os.path.join(workdir, "config_standard_MSM_strain")
    with open(conf, "w") as f:
        f.write(STRAIN_CONFIG)
    metrics = os.path.join(workdir, "metrics.jsonl")
    out = os.path.join(workdir, "out_")
    print(f"main: ico-{meshes[0].get_resolution()} subject, "
          f"{meshes[0].nvertices} vertices, "
          f"{datasets[0].shape[0]} channels; inputs written in "
          f"{time.perf_counter() - t0:.2f} s")
    print(f"reduced: --it={SMOKE_ITERS} (config_standard_MSM_strain has "
          f"--it={STANDARD_ITERS}); nothing else cut")

    def run_cli(prefix, metrics_path):
        t0 = time.perf_counter()
        rc = cli.main(["--inmesh", paths["in"][0], "--refmesh",
                       paths["ref"][0], "--indata", paths["in"][1],
                       "--refdata", paths["ref"][1], "-o", prefix, "--conf",
                       conf, "--metrics", metrics_path, "--device", "cuda"])
        torch.cuda.synchronize()
        check(rc == 0, f"cli returned {rc}")
        return time.perf_counter() - t0

    locate.LAUNCHES = 0
    wall = run_cli(out, metrics)
    launches = locate.LAUNCHES
    print(f"main: cli wall {wall:.2f} s, locate_bary launches {launches}")
    if warm_runs:
        warm = [run_cli(os.path.join(workdir, f"warm{i}_"),
                        os.path.join(workdir, f"warm{i}.jsonl"))
                for i in range(warm_runs)]
        print(f"main: {warm_runs} more runs in this process: "
              f"{[round(w, 4) for w in warm]} s, median "
              f"{float(np.median(warm)):.4f} s")

    events = [json.loads(line) for line in open(metrics)]
    for e in events:
        if e["event"] == "level":
            print(f"level {e['level']} ({e['cost']}): wall {e['wall_s']} s")
    warp = {(e["level"], e["iter"]): e["warp_s"] for e in events
            if e["event"] == "warp"}
    energies = []
    n_queries = 0
    first_setup = {}
    last_level = max(e["level"] for e in events if e["event"] == "iter")
    for e in events:
        if e["event"] == "iter":
            if e["level"] == last_level:
                # the largest locate call at MAIN_RES: K control points x
                # lchunk(4) labels x pmax patch slots
                n_queries = max(n_queries,
                                e["cps"] * min(4, e["labels"]) * e["pmax"])
            first_setup.setdefault(e["level"], e["setup_s"])
            energies.append(e["energy"])
            print(f"iter level {e['level']} it {e['iter']}: energy "
                  f"{e['energy']:.6f} setup {e['setup_s']} s unary "
                  f"{e['unary_s']} s fusion {e['fusion_s']} s warp "
                  f"{warp.get((e['level'], e['iter']), 'n/a')} s")
    print("first set-up seconds of each level (cold host table builds): "
          + ", ".join(f"level {lv}: {t}" for lv, t in first_setup.items()))
    check(launches > 0, "the main path never launched the locate kernel")
    check(energies and all(np.isfinite(energies)),
          f"energies not finite: {energies}")
    for suffix in ("sphere.reg.surf.gii", "transformed_and_reprojected.func.gii"):
        check(os.path.exists(out + suffix), f"missing output {suffix}")
    warped = Mesh.load(out + "sphere.reg.surf.gii")
    folds = count_folds(warped, device="cuda")
    transformed = mio.load_data(out + "transformed_and_reprojected.func.gii",
                                template)
    check(transformed.shape == template_data.shape
          and np.isfinite(transformed).all(),
          f"transformed data malformed: {transformed.shape}")
    cc_before = _cc(datasets[0][0], template_data[0])
    cc_after = _cc(transformed[0], template_data[0])
    print(f"main: folds {folds}; sulc CC to template before {cc_before:.4f} "
          f"after {cc_after:.4f}")
    check(folds == 0, f"warped sphere has {folds} folds")
    check(cc_after > cc_before, "registration did not raise the sulc CC")
    return launches, n_queries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warm-runs", type=int, default=0,
                    help="after the main path, time this many more runs of "
                         "it in the same process (tables cached)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import newmsm_tpu_torch  # noqa: F401  (fails outside the repo)

    phase_device(torch)
    phase_build()
    max_err = phase_kernel(torch)
    with tempfile.TemporaryDirectory() as workdir:
        launches, n_queries = phase_main(torch, workdir, args.warm_runs)
    k, plain, roof = phase_timing(torch, n_queries, MAIN_RES)
    # library_ms: no single PyTorch call computes point location on a
    # subdivision tree plus barycentric weights
    print(json.dumps({"kernels": [{
        "name": "locate_bary", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": k["ms"], "plain_ms": plain["ms"],
        "bound_ms": roof["bound_ms"], "bound_by": roof["bound_by"],
        "library_ms": None, "ms_spread": k["ms_spread"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
