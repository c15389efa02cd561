"""Build and load the package's CUDA kernels (nvcc -> shared library with a
plain C interface -> ctypes).

Each source under newmsm_tpu_torch/csrc is compiled at first use for
sm_90a into <repo>/build/newmsm_tpu_torch/, under a name keyed by a hash of
the source and the compile command, so an edited source rebuilds and an
unchanged one loads the cached library. The compiler's output (the
`-Xptxas -v` lines: registers, spills) is kept beside the library.
Nothing here runs at import time.
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


def build(source, flags=NVCC_FLAGS) -> pathlib.Path:
    """Compile `source` (a name under csrc/, or a path) if its library is
    not there yet; returns the library's path."""
    out = library_path(source, flags)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = nvcc_command(source_path(source), tmp, find_cuda_tool(), flags)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} (rc "
                               f"{proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return out


def load(source, flags=NVCC_FLAGS) -> ctypes.CDLL:
    """Build (if needed) and load a kernel source; returns the ctypes
    library. Under tracing, a `k1.load` mark."""
    with trace.mark("k1.load"):
        return ctypes.CDLL(str(build(source, flags)))


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
