"""Build and load the package's CUDA kernels (nvcc -> shared library with a
plain C interface -> ctypes).

Each source under newmsm_tpu_torch/csrc is compiled at first use for
sm_90a into <repo>/build/newmsm_tpu_torch/, under a name keyed by a hash of
the source and the compile command, so an edited source rebuilds and an
unchanged one loads the cached library. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "newmsm_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of newmsm_tpu_torch are built from source at "
                           "first use")
    return nvcc


def nvcc_command(source: pathlib.Path, output: pathlib.Path,
                 nvcc: str = "nvcc") -> list:
    """The compile command for one kernel source."""
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def library_path(name: str) -> pathlib.Path:
    source = CSRC_DIR / name
    key = hashlib.sha256(source.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{key}.so"


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>; returns the ctypes library."""
    out = library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = nvcc_command(CSRC_DIR / name, tmp, find_nvcc())
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} (rc "
                               f"{proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))
