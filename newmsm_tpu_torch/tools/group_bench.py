"""Wall and stage times of the groupwise CLI on one card, for one or more
checkouts of this package in turns.

    python -m newmsm_tpu_torch.tools.group_bench [--tree DIR ...]
        [--order 0,1,1,0] [--subjects 6] [--res 6] [--iters 2,2,2]
        [--json OUT]

Writes a synthetic cohort (eval.synth.synth_cohort(res, subjects,
seed=0)), an ico-res template and the gMSM tutorial config (CP 2/3/4, SG
4/5/6, datagrid 4/5/6, lambda 0.3, HOCR, regoption 3; --it as given) once.
Then it runs `python -m newmsm_tpu_torch.cli --groupwise ... --device cuda
--metrics` as a fresh process from each tree in the order given: tree 0 is
the checkout this module belongs to, --tree adds trees 1, 2, ... (another
version of the repository), so that versions are compared under one clock
and power state. Each tree builds its kernel once before the first timed
run. Per run it prints the process wall, the level walls, setup_s and
opt_s of every iteration; it fails when two runs' energies differ. Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TUTORIAL_CONFIG = """\
--simval=2,2,2
--sigma_in=0,0,0
--sigma_ref=0,0,0
--lambda=0.3,0.3,0.3
--it={iters}
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


def write_inputs(workdir: str, subjects: int, res: int, iters: str) -> list:
    """The cohort, template, list files and config; returns the CLI's
    arguments without -o / --metrics."""
    from ..core.mesh import Mesh
    from ..eval.synth import synth_cohort
    meshes, datasets, _ = synth_cohort(res, subjects, seed=0)
    mesh_paths, data_paths = [], []
    for s in range(subjects):
        mesh_paths.append(os.path.join(workdir, f"s{s}.surf.gii"))
        data_paths.append(os.path.join(workdir, f"s{s}.func.gii"))
        meshes[s].save(mesh_paths[-1])
        Mesh(coords=meshes[s].coords, faces=meshes[s].faces,
             data=datasets[s]).save(data_paths[-1])
    for name, paths in (("meshes", mesh_paths), ("data", data_paths)):
        with open(os.path.join(workdir, f"{name}.txt"), "w") as f:
            f.write("\n".join(paths) + "\n")
    template = Mesh.from_icosphere(res)
    template.true_rescale(100.0)
    template.save(os.path.join(workdir, "template.surf.gii"))
    with open(os.path.join(workdir, "group.conf"), "w") as f:
        f.write(TUTORIAL_CONFIG.format(iters=iters))
    return ["--groupwise", "--meshes", os.path.join(workdir, "meshes.txt"),
            "--data", os.path.join(workdir, "data.txt"), "--template",
            os.path.join(workdir, "template.surf.gii"), "--conf",
            os.path.join(workdir, "group.conf"), "--device", "cuda"]


def _env(tree: str) -> dict:
    return dict(os.environ, PYTHONPATH=tree)


def run_once(tree: str, cli_args: list, out: str) -> dict:
    """One CLI process from `tree`; its wall and its metrics events."""
    metrics = out + "metrics.jsonl"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "newmsm_tpu_torch.cli",
                           *cli_args, "-o", out, "--metrics", metrics],
                          cwd=tree, env=_env(tree), capture_output=True,
                          text=True, timeout=1800)
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(f"{tree}: cli returned {proc.returncode}\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    events = [json.loads(line) for line in open(metrics)]
    iters = [e for e in events if e["event"] == "iter"]
    return dict(
        wall_s=wall,
        level_wall_s=[e["wall_s"] for e in events if e["event"] == "level"],
        level_init_s=[e["init_s"] for e in events if e["event"] == "level"],
        setup_s=[e["setup_s"] for e in iters],
        opt_s=[e["opt_s"] for e in iters],
        pmax=[e["pmax"] for e in iters],
        energies=[e["energy"] for e in iters])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="another checkout of the repository (tree 1, 2, ...)")
    ap.add_argument("--order", default="0",
                    help="comma-separated tree indices, one run each")
    ap.add_argument("--subjects", type=int, default=6)
    ap.add_argument("--res", type=int, default=6)
    ap.add_argument("--iters", default="2,2,2")
    ap.add_argument("--json", default=None, help="write the runs here")
    args = ap.parse_args(argv)
    trees = [HERE] + [os.path.abspath(t) for t in args.tree]
    order = [int(i) for i in args.order.split(",")]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    print(card)
    for i, tree in enumerate(trees):
        if i in order:
            subprocess.run([sys.executable, "-c", "from newmsm_tpu_torch.ops "
                            "import locate; locate._library()"], cwd=tree,
                           env=_env(tree), check=True, timeout=600)
    runs = []
    with tempfile.TemporaryDirectory() as workdir:
        cli_args = write_inputs(workdir, args.subjects, args.res, args.iters)
        for n, i in enumerate(order):
            r = run_once(trees[i], cli_args,
                         os.path.join(workdir, f"run{n}_"))
            r["tree"] = i
            runs.append(r)
            print(f"run {n} tree {i}: wall {r['wall_s']:.2f} s; level walls "
                  f"{r['level_wall_s']} s (set-up {r['level_init_s']}); "
                  f"setup_s {r['setup_s']}; opt_s {r['opt_s']}; pmax "
                  f"{r['pmax']}", flush=True)
    same = all(r["energies"] == runs[0]["energies"] for r in runs)
    print(f"energies bitwise equal across the runs: {same}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=card, trees=trees, runs=runs), f, indent=1)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
