"""`newmsm`-compatible command line for the PyTorch port (msmOptions.h:
59-157, newmsm.cpp:6-72), with a --device flag:

    python -m newmsm_tpu_torch.cli --inmesh in.surf.gii --refmesh ref.surf.gii \\
        --indata in.func.gii --refdata ref.func.gii -o out/ --conf config \\
        --device cuda

--device defaults to cuda and raises when CUDA is missing; pass
--device cpu to run on the CPU. Every configuration of the JAX package's CLI
runs (--inanat/--refanat for regoption 5, --profile DIR for a torch.profiler
trace), and the groupwise mode:

    python -m newmsm_tpu_torch.cli --groupwise --meshes meshes.txt \\
        --data data.txt --template template.surf.gii -o out/ --conf config

The groupwise mode runs subject-sharded over W ranks under torchrun (or
SLURM with MASTER_ADDR / MASTER_PORT set), each rank on its own device
(cuda:{LOCAL_RANK % cards}, or the CPU):

    python -m torch.distributed.run --standalone --nproc_per_node=W \\
        -m newmsm_tpu_torch.cli --groupwise ... [--device cpu] \\
        [--dist-backend gloo|nccl]

--dist-backend defaults to gloo on the CPU and nccl on CUDA when every rank
has a card; ranks that share a card must name gloo. Without rank variables
the CLI is one process on one device.
"""
from __future__ import annotations

import argparse
import sys

import torch

from . import resolve_device, trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="newmsm-torch", add_help=False,
        description="Multimodal Surface Matching on PyTorch / CUDA "
                    "(newMSM-compatible)")
    p.add_argument("-h", "--help", action="help")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-p", "--printoptions", action="store_true",
                   help="print configuration file options")
    p.add_argument("-d", "--debug", action="store_true")
    p.add_argument("-g", "--groupwise", action="store_true")
    p.add_argument("-m", "--meshes", default="",
                   help="groupwise: list file of input sphere paths")
    p.add_argument("-s", "--template", default="",
                   help="groupwise: template sphere")
    p.add_argument("-l", "--data", default="",
                   help="groupwise: list file of data paths")
    p.add_argument("-k", "--mask", default="")
    p.add_argument("-M", "--inmesh", default="")
    p.add_argument("-R", "--refmesh", default="")
    p.add_argument("-a", "--inanat", default="")
    p.add_argument("-A", "--refanat", default="")
    p.add_argument("-i", "--indata", default="")
    p.add_argument("-I", "--refdata", default="")
    p.add_argument("-t", "--trans", default="")
    p.add_argument("-w", "--inweight", default="")
    p.add_argument("-W", "--refweight", default="")
    p.add_argument("-o", "--out", default="")
    p.add_argument("-f", "--format", default="GIFTI",
                   choices=["GIFTI", "VTK", "ASCII", "ASCII_MAT"])
    p.add_argument("-c", "--conf", default="", help="configuration file")
    p.add_argument("--metrics", default="",
                   help="write the run's JSONL events and spans to this "
                        "file (tracing on)")
    p.add_argument("--profile", default="",
                   help="write a torch.profiler trace (Chrome trace JSON, "
                        "trace.json) to this directory")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    p.add_argument("--dist-backend", default=None, choices=["gloo", "nccl"],
                   help="groupwise under torchrun: the torch.distributed "
                        "backend (default gloo on the CPU, nccl on CUDA "
                        "with a card per rank)")
    return p


def read_list_file(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def print_config_options():
    from .reg import config as C
    print("newmsm configuration parameters (per-level lists are comma separated):")
    for flag in sorted(list(C._LIST_FLAGS) + list(C._SCALAR_FLAGS)
                       + list(C._BOOL_FLAGS) + ["INc"]):
        print(f"  --{flag}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.printoptions:
        print_config_options()
        return 0
    if args.groupwise:
        import torch.distributed as dist
        from .parallel import multihost as mh
        from .reg.group import GroupMeshRegistration
        device = resolve_device(args.device)
        mh.initialize(args.dist_backend, device)
        try:
            gmr = GroupMeshRegistration(
                device=mh.rank_device(device),
                group=dist.group.WORLD if dist.is_initialized() else None)
            if args.verbose:
                print(f"This is newmsm_tpu_torch on {gmr.device}, rank "
                      f"{gmr.comm.rank} of {gmr.comm.world}.")
            gmr.verbose = args.verbose
            gmr.debug = args.debug
            gmr.metrics_path = args.metrics or None
            gmr.profile_dir = args.profile or None
            gmr.outdir = args.out
            gmr.set_inputs(read_list_file(args.meshes))
            gmr.set_data_list(read_list_file(args.data))
            gmr.set_template(args.template)
            if args.mask:
                gmr.set_mask(args.mask)
            gmr.run_multiresolutions(args.conf or None)
        finally:
            mh.shutdown()
        return 0
    if not args.inmesh:
        print("error: --inmesh is required", file=sys.stderr)
        return 1
    if bool(args.inanat) != bool(args.refanat):
        print("error: must supply both anatomical meshes or none",
              file=sys.stderr)
        return 1

    # --metrics: the tracer opens here, so that start-up is a span of the
    # run (cli.start: imports, the CUDA context, the kernels' libraries,
    # inputs)
    device = resolve_device(args.device)
    with trace.run(args.metrics or None, device):
        with trace.span("cli.start"):
            from .reg.driver import MeshRegistration
            if device.type == "cuda":
                from .ops import icm, locate
                with trace.mark("cuda.init"):
                    torch.cuda.synchronize(device)
                locate.kernel_tables(device)
                icm.SEAM.library()
            mr = MeshRegistration(device=device)
            if args.verbose:
                print(f"This is newmsm_tpu_torch on {mr.device}.")
            mr.verbose = args.verbose
            mr.metrics_path = args.metrics or None
            mr.profile_dir = args.profile or None
            mr.debug = args.debug
            mr.outdir = args.out
            with trace.mark("cli.inputs"):
                mr.set_input(args.inmesh)
                mr.set_reference(args.refmesh if args.refmesh
                                 else args.inmesh)
                if args.indata:
                    mr.set_input_data(args.indata)
                if args.refdata:
                    mr.set_reference_data(args.refdata)
                if args.inanat:
                    mr.set_anatomical(args.inanat, args.refanat)
                mr.set_output_format(args.format)
                if args.trans:
                    mr.set_transformed(args.trans)
                if args.inweight:
                    mr.set_input_cfweighting(args.inweight)
                if args.refweight:
                    mr.set_reference_cfweighting(args.refweight)
        mr.run_multiresolutions(args.conf or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
