"""Build and load the package's CUDA kernels (nvcc -> shared library with a
plain C interface -> ctypes), and the one seam through which each of them
joins the port (`Kernel`).

Each source under newmsm_tpu_torch/csrc is compiled at first use for
sm_90a into <repo>/build/newmsm_tpu_torch/, under a name keyed by a hash of
the source and the compile command, so an edited source rebuilds and an
unchanged one loads the cached library. At the default flags the first
build of any csrc/ source builds every csrc/ source whose library is
missing (`build_all`), so that one build before a timed window leaves no
nvcc run for later. The compiler's
output (the `-Xptxas -v` lines: registers, spills) is kept beside the
library.
Nothing here runs at import time.

A wrapper module under ops/ holds what is its own (its source, its C
signatures, its plain PyTorch twin, the shape relations only it checks,
one public entry) and one `Kernel`, which does the rest the same way for
every kernel: loads the library with its C functions declared, checks an
argument (`need`), launches on the tensor's device and PyTorch's current
stream, picks kernel or twin by device and counts each call. There is no
fallback from a kernel to its twin: the comparison of the two runs in
tests/test_torch_cuda.py and in chip_smoke.py, which fail on a mismatch.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess

import torch

from .. import trace

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "newmsm_tpu_torch"

# -ftz=true: every rsqrt argument of the kernels is the squared length of a
# unit-scale vector, so the denormal fix-up around the special-function
# instruction is dead weight. Not -use_fast_math: divisions and square
# roots stay IEEE.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-ftz=true", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")


def find_cuda_tool(tool: str = "nvcc") -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", tool)):
            return os.path.join(cand, "bin", tool)
    path = shutil.which(tool)
    if path is None:
        raise RuntimeError(f"{tool} not found (set CUDA_HOME); the CUDA "
                           "kernels of newmsm_tpu_torch are built from "
                           "source at first use")
    return path


def nvcc_command(source: pathlib.Path, output: pathlib.Path,
                 nvcc: str = "nvcc", flags=NVCC_FLAGS) -> list:
    """The compile command for one kernel source."""
    return [nvcc, *flags, "-o", str(output), str(source)]


def source_path(source) -> pathlib.Path:
    """A bare file name means a source under csrc/; anything with a
    directory part is a path of its own."""
    source = pathlib.Path(source)
    return CSRC_DIR / source if len(source.parts) == 1 else source.resolve()


def library_path(source, flags=NVCC_FLAGS) -> pathlib.Path:
    """Where the library of `source` (a name under csrc/, or a path) goes."""
    source = source_path(source)
    key = hashlib.sha256(source.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{key}.so"


def _compile(source: pathlib.Path, flags) -> pathlib.Path:
    out = library_path(source, flags)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = nvcc_command(source, tmp, find_cuda_tool(), flags)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source.name} (rc "
                               f"{proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return out


def build_all(flags=NVCC_FLAGS) -> None:
    """Compile every csrc/ source whose library is missing. `build` calls
    it for the program's own flags, so that the first build of any kernel
    (the benchmark builds K1 in its set-up) leaves no nvcc run for a timed
    window."""
    for src in sorted(CSRC_DIR.glob("*.cu")):
        _compile(src, flags)


def build(source, flags=NVCC_FLAGS) -> pathlib.Path:
    """Compile `source` (a name under csrc/, or a path) if its library is
    not there yet; returns the library's path. A csrc/ source at the
    default NVCC_FLAGS brings the others with it (`build_all`); other
    flags and other paths build the one source alone."""
    src = source_path(source)
    if src.parent == CSRC_DIR and tuple(flags) == NVCC_FLAGS:
        build_all()
    return _compile(src, flags)


def load(source, flags=NVCC_FLAGS, *, mark: str) -> ctypes.CDLL:
    """Build (if needed) and load a kernel source; returns the ctypes
    library. Under tracing, a `mark` mark (the caller's: K1's `k1.load`,
    K2's `k2.load`)."""
    with trace.mark(mark):
        return ctypes.CDLL(str(build(source, flags)))


# the C types of the signature tables
PTR, INT, LONG, FLOAT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)

KERNELS: dict = {}      # name -> Kernel: every kernel of the port imported


class Kernel:
    """One hand-written kernel as the port reaches it. `name` is its trace
    prefix (K1 `locate`), `source` its file under csrc/ (whose stem names
    the kernel in errors), `entry` the wrapper's public function, `mark`
    the trace mark of its load, and `functions` its C signatures: {C name:
    (argtypes, restype)}, a launch function taking the stream last and
    returning a CUDA error code.

    `tally` is this process's count of the entry's calls: `kernel` and
    `twin`, and `largest`, the most elements of the lead tensor of one
    kernel call (K1's queries); `reset_tallies` zeroes every kernel's."""

    def __init__(self, name: str, source: str, entry: str, mark: str,
                 functions: dict):
        self.name, self.source, self.entry = name, source, entry
        self.label = pathlib.Path(source).stem
        self.mark, self.functions = mark, functions
        self.tally = {"kernel": 0, "twin": 0, "largest": 0}
        self._counts = (f"{name}.kernel", f"{name}.twin")
        self.library = trace.cached()(self._load)
        KERNELS[name] = self

    def declare(self, lib: ctypes.CDLL) -> ctypes.CDLL:
        """Declare the C functions of the signature table that `lib` (this
        kernel's library, or a build of another source with its
        interface) has; returns lib."""
        for fname, (argtypes, restype) in self.functions.items():
            if hasattr(lib, fname):
                fn = getattr(lib, fname)
                fn.argtypes, fn.restype = argtypes, restype
        return lib

    def _load(self) -> ctypes.CDLL:
        return self.declare(load(self.source, mark=self.mark))

    def need(self, name: str, t, dtype, device, ndim=None,
             cols=None) -> None:
        """Raise unless tensor `t`, argument `name`, lies on `device` and
        has `dtype`, `ndim` dimensions and `cols` columns where given, and
        is contiguous: TypeError for the dtype, ValueError for the rest.
        Reads no device value."""
        where = f"{self.label}: {name}"
        if t.device != device:
            raise ValueError(f"{where} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{where} must be {dtype}, got {t.dtype}")
        if ndim is not None and t.dim() != ndim:
            raise ValueError(f"{where} must have {ndim} dimensions, got "
                             f"shape {tuple(t.shape)}")
        if cols is not None and t.shape[1] != cols:
            raise ValueError(f"{where} must have {cols} columns, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{where} must be contiguous")

    def call(self, function: str, device, *args, lib=None) -> None:
        """One unchecked launch: C function `function` of the library (or
        of `lib`) with `args` and PyTorch's current stream, inside
        `device`; raises on a CUDA error. Counts nothing."""
        fn = getattr(self.library() if lib is None else lib, function)
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.label} kernel launch failed: CUDA "
                               f"error {rc}")

    def run(self, lead, twin, kernel, *args):
        """The entry's one choice: `twin(*args)` when the lead tensor lies
        on the CPU, `kernel(*args)` (which checks and launches) when on a
        CUDA card; any other device raises, with no fallback. A call that
        returns is counted once: the trace count `<name>.kernel` or
        `<name>.twin`, and the tally."""
        kind = lead.device.type
        if kind == "cuda":
            out = kernel(*args)
            self.tally["kernel"] += 1
            self.tally["largest"] = max(self.tally["largest"], lead.numel())
            trace.count(self._counts[0])
        elif kind == "cpu":
            out = twin(*args)
            self.tally["twin"] += 1
            trace.count(self._counts[1])
        else:
            raise ValueError(f"{self.entry}: unsupported device "
                             f"{lead.device}")
        return out


def reset_tallies() -> None:
    """Zero the tally of every kernel."""
    for k in KERNELS.values():
        k.tally.update(kernel=0, twin=0, largest=0)


def compiler_log(source, flags=NVCC_FLAGS) -> str:
    """What nvcc / ptxas printed when the library of `source` was built."""
    return build(source, flags).with_suffix(".log").read_text()


def ptxas_usage(source, function: str, flags=NVCC_FLAGS) -> str:
    """The `ptxas -v` resource line (registers, spills, constant memory) of
    the first compiled function whose mangled name contains `function`."""
    lines = compiler_log(source, flags).splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and function in line:
            usage = [ln.split("ptxas info    : ", 1)[-1].strip()
                     for ln in lines[i + 1:i + 4]
                     if "Used" in ln or "spill" in ln]
            return "; ".join(usage)
    raise RuntimeError(f"no ptxas line for {function} in the build log of "
                       f"{source}")


def sass_opcodes(source, function: str, flags=NVCC_FLAGS) -> collections.Counter:
    """Instructions by opcode (NOP padding excluded) of the first SASS
    function of the library whose mangled name contains `function`
    (cuobjdump -sass). Their sum is the function's instruction count."""
    proc = subprocess.run(
        [find_cuda_tool("cuobjdump"), "-sass", str(build(source, flags))],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {proc.stderr}")
    counts, inside = collections.Counter(), False
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = function in line
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\d+\s+)?([A-Z0-9_]+)",
                         line)
            if m and m.group(2) != "NOP":
                counts[m.group(2)] += 1
    if not counts:
        raise RuntimeError(f"no SASS function matching {function}")
    return counts
