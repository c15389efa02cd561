"""newmsm_tpu_torch — the PyTorch / CUDA port of newmsm_tpu.

The pairwise strain-registration path of the JAX package, rewritten on
torch tensors, with the one Pallas kernel of the JAX package (the pristine
icosphere locate, ``newmsm_tpu/ops/pallas_locate.py``) written by hand in
CUDA C++ for Hopper (``csrc/locate_bary.cu``), and two more hand-written
kernels (``csrc/icm_binary.cu``, ``csrc/rigid_cost.cu``). Layout mirrors
the JAX package, so every ported module sits at the same relative path:

  core/      spherical math; host topology (icosphere, mesh) and file I/O
  ops/       the kernels' wrappers and twins (locate, icm, rigid) over one
             seam (_build), nearest-triangle search, resampling,
             smoothing, strain, unfolding, similarity
  reg/       featurespace, discrete model, cost volumes, fusion optimiser,
             rigid alignment, the pairwise multiresolution driver
  eval/      synthetic cohorts (the smoke run's and the tests' input)
  cli.py     `newmsm`-compatible command line with a --device flag

The port stands alone: it imports torch, numpy, scipy and the standard
library, never jax and nothing of newmsm_tpu. The host modules it needs
(core.icosphere, core.mesh, core.io, reg.config, reg.sampling_grid,
reg.optimise.coloring, eval.synth) are its own copies, with the host
tables built by whole-array numpy / scipy.sparse (no compiled host
extension). Every public function that takes `device` defaults to cuda
(`resolve_device`) and raises without a card; pass device="cpu" for the CPU.
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


def resolve_device(device=None) -> torch.device:
    """torch.device for `device`, None meaning cuda: the one default of every
    public function of the port. Raises when CUDA is asked for and absent
    (the port never falls back to the CPU on its own)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but CUDA is not "
                           "available (pass device='cpu' to run on the CPU)")
    return dev
