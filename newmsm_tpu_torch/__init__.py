"""newmsm_tpu_torch — the PyTorch / CUDA port of newmsm_tpu.

The pairwise strain-registration path of the JAX package, rewritten on
torch tensors, with the one Pallas kernel of the JAX package (the pristine
icosphere locate, ``newmsm_tpu/ops/pallas_locate.py``) written by hand in
CUDA C++ for Hopper (``csrc/locate_bary.cu``). Layout mirrors the JAX
package, so every ported module sits at the same relative path:

  core/      spherical math (host topology is reused from newmsm_tpu.core)
  ops/       nearest-triangle search + the locate kernel's wrapper,
             resampling, smoothing, strain, unfolding, similarity
  reg/       featurespace, discrete model, cost volumes, fusion optimiser,
             rigid alignment, the pairwise multiresolution driver
  cli.py     `newmsm`-compatible command line with a --device flag

The port imports torch and numpy and never jax: the JAX-free host modules
of newmsm_tpu (core.icosphere, core.mesh, core.io, reg.config,
reg.sampling_grid, reg.optimise.coloring, eval.synth, native) are reused,
everything else is ported.
"""
import torch

RAD = 100.0          # sphere radius used throughout (reference point.h:32)
EPSILON = 1e-8       # geometric tolerance (reference point.h:31)
FOLDING = 1e7        # folding penalty (reference reg_tools.h:30)
FIX_NAN = 1e7        # NaN replacement cost (reference reg_tools.h:31)

__version__ = "0.1.0"

# Coordinate-carrying matmuls (the |a|^2-2a.b+|b|^2 patch distances, the
# label rotations, the smoothing and rigid neighbourhood dots) decide
# boundary membership: TF32's ~3 significant digits would move those
# decisions, the failure the JAX package prevents with Precision.HIGHEST.
# Set once here, for the whole package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent
    (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available (pass device='cpu' to run on the CPU)")
    return dev
