"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/repro_torch/`` at the repository root,
then loaded with ``ctypes``. The library name carries a hash of the source
and flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing here runs at import time: the CPU tests import every module and
have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "KernelLaunchError", "cuda_tool",
           "build_library", "load_library"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict = {}  # source name -> (ctypes.CDLL, build log)


class KernelLaunchError(RuntimeError):
    """A kernel's launcher returned a CUDA error: a device fault, which the
    training loop's retry (``dist.fault_tolerance``) never swallows."""


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): on the PATH
    or under /usr/local/cuda/bin."""
    found = shutil.which(name)
    if found:
        return found
    cand = Path("/usr/local/cuda/bin") / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"{name} not found: the CUDA kernels cannot be built or read")


def build_library(source: str) -> tuple[Path, str]:
    """Compile ``csrc/<source>`` (if not already built); return (path, log).

    The log is nvcc's output (``-Xptxas -v`` prints registers, shared memory
    and spills per kernel), empty when the library was already built."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {src.name}:\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, proc.stdout + proc.stderr


def load_library(source: str) -> tuple[ctypes.CDLL, str]:
    """Build (if needed) and load ``csrc/<source>``; cached per process."""
    hit = _LOADED.get(source)
    if hit is None:
        path, log = build_library(source)
        hit = (ctypes.CDLL(str(path)), log)
        _LOADED[source] = hit
    return hit
