"""Build a ``csrc/*.cu`` source with nvcc and load it with ctypes.

Each source has a plain C interface and builds into its own shared library
under ``build/torch_kernels/``, named by the source's stem and a hash of
its bytes and the flags, so an edited source builds anew. The build runs at
first use (a few seconds), never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
# No --use_fast_math: K1 must stay bit-identical to its plain version, and
# the GBA's cost gate compares two K3 costs computed in IEEE f32.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset, no nvcc)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: str) -> str:
    """Path of ``source``'s built library."""
    h = hashlib.sha1()
    with open(source, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"libmcs_{stem}_{h.hexdigest()[:12]}.so")


def build(source: str) -> str:
    """Compile ``source`` with nvcc unless already built. Returns the
    compiler's output (the ptxas register and shared-memory report), or ""
    if the library was already there."""
    path = library_path(source)
    if os.path.exists(path):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, path)
    return r.stdout + r.stderr


def load(source: str, signatures: dict) -> ctypes.CDLL:
    """Build ``source`` if needed and load it. ``signatures`` maps each C
    entry point to its argtypes; every entry point returns an int (the
    cudaError_t of its launch)."""
    build(source)
    lib = ctypes.CDLL(library_path(source))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
