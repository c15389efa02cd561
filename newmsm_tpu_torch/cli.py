"""`newmsm`-compatible command line for the PyTorch port (msmOptions.h:
59-157, newmsm.cpp:6-72), with a --device flag:

    python -m newmsm_tpu_torch.cli --inmesh in.surf.gii --refmesh ref.surf.gii \\
        --indata in.func.gii --refdata ref.func.gii -o out/ --conf config \\
        --device cuda

--device defaults to cuda and raises when CUDA is missing; pass
--device cpu to run on the CPU.
"""
from __future__ import annotations

import argparse
import sys


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
                   help="write per-iteration JSONL metrics to this file")
    p.add_argument("--profile", default="",
                   help="device trace directory (not ported yet)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    return p


def print_config_options():
    from newmsm_tpu.reg import config as C
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
        raise NotImplementedError("--groupwise is not yet ported to "
                                  "newmsm_tpu_torch (ROADMAP.md queue 1)")
    if args.profile:
        raise NotImplementedError("--profile is not yet ported to "
                                  "newmsm_tpu_torch (ROADMAP.md queue 1)")
    if args.inanat or args.refanat:
        raise NotImplementedError("anatomical meshes (aMSM) are not yet "
                                  "ported to newmsm_tpu_torch (ROADMAP.md "
                                  "queue 1)")
    if not args.inmesh:
        print("error: --inmesh is required", file=sys.stderr)
        return 1

    from .reg.driver import MeshRegistration
    mr = MeshRegistration(device=args.device)
    if args.verbose:
        print(f"This is newmsm_tpu_torch on {mr.device}.")
    mr.verbose = args.verbose
    mr.metrics_path = args.metrics or None
    mr.debug = args.debug
    mr.outdir = args.out
    mr.set_input(args.inmesh)
    mr.set_reference(args.refmesh if args.refmesh else args.inmesh)
    if args.indata:
        mr.set_input_data(args.indata)
    if args.refdata:
        mr.set_reference_data(args.refdata)
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
