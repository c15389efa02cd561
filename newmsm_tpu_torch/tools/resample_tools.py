"""Standalone resampling tools — equivalents of the reference demo CLIs
(libraries/msm-newresampler/demo/: metric-resample, surface-resample,
smoothing, NN-resample, applywarp). Each wraps one ops.resample entry point
and doubles as a unit-test harness against real surface files.

Usage:  python -m newmsm_tpu_torch.tools.resample_tools [--device cpu] <tool> [args]

--device defaults to cuda and raises when CUDA is missing.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import RAD
from ..core.mesh import Mesh
from ..core import io as mio
from ..ops import resample as rsp


def _load_sphere(path: str) -> Mesh:
    m = Mesh.load(path)
    m.recentre()
    m.true_rescale(RAD)
    return m


def metric_resample(args):
    data_mesh = _load_sphere(args.sphere)
    data_mesh.set_data(mio.load_data(args.data, data_mesh))
    target = _load_sphere(args.target)
    excl = None
    if args.exclusion:
        excl = mio.load_data(args.exclusion, data_mesh)[0]
    out, _ = rsp.metric_resample(data_mesh, target, excl, args.device)
    out.save(args.output)


def surface_resample(args):
    anat = Mesh.load(args.anatomy)
    sph_orig = _load_sphere(args.sphere)
    target = _load_sphere(args.target)
    rsp.surface_resample(anat, sph_orig, target, args.device).save(args.output)


def smoothing(args):
    mesh = _load_sphere(args.sphere)
    mesh.set_data(mio.load_data(args.data, mesh))
    out, _ = rsp.smooth_data(mesh, args.sigma, device=args.device)
    out.save(args.output)


def nn_resample(args):
    data_mesh = _load_sphere(args.sphere)
    data_mesh.set_data(mio.load_data(args.data, data_mesh))
    target = _load_sphere(args.target)
    out, _ = rsp.nearest_neighbour_interpolation(data_mesh, target,
                                                 device=args.device)
    out.save(args.output)


def applywarp(args):
    """demo/applywarp.cpp:25-37: warp a sphere through (original -> warped)
    control correspondence."""
    sphere = _load_sphere(args.sphere)
    original = _load_sphere(args.original)
    warped = _load_sphere(args.warped)
    rsp.sphere_project_warp(sphere, original, warped,
                            args.device).save(args.output)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="newmsm-torch-resample")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    sub = p.add_subparsers(dest="tool", required=True)

    mt = sub.add_parser("metric-resample")
    mt.add_argument("sphere"); mt.add_argument("data"); mt.add_argument("target")
    mt.add_argument("output"); mt.add_argument("--exclusion")
    mt.set_defaults(fn=metric_resample)

    sr = sub.add_parser("surface-resample")
    sr.add_argument("anatomy"); sr.add_argument("sphere"); sr.add_argument("target")
    sr.add_argument("output")
    sr.set_defaults(fn=surface_resample)

    sm = sub.add_parser("smoothing")
    sm.add_argument("sphere"); sm.add_argument("data")
    sm.add_argument("sigma", type=float); sm.add_argument("output")
    sm.set_defaults(fn=smoothing)

    nn = sub.add_parser("nn-resample")
    nn.add_argument("sphere"); nn.add_argument("data"); nn.add_argument("target")
    nn.add_argument("output")
    nn.set_defaults(fn=nn_resample)

    aw = sub.add_parser("applywarp")
    aw.add_argument("sphere"); aw.add_argument("original"); aw.add_argument("warped")
    aw.add_argument("output")
    aw.set_defaults(fn=applywarp)

    args = p.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
