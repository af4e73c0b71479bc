"""Build-on-first-use loader for the port's CUDA kernels.

Each ``.cu`` file under ``cvmatrix_tpu_torch/csrc/`` exposes a plain C
interface. It is compiled by ``nvcc`` for ``sm_90a`` (Hopper) into a shared
library under :func:`build_dir` the first time a kernel is launched, keyed by
a hash of the source, the flags and the compiler's version, and loaded with
``ctypes``. Nothing is built or loaded at import time. A failed build raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

__all__ = ["NVCC_FLAGS", "build_dir", "find_nvcc", "load_library"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}


def build_dir() -> str:
    """``<checkout>/.cache/cvmatrix_tpu_torch`` (ignored by git)."""
    d = os.path.join(os.path.dirname(_PKG), ".cache", "cvmatrix_tpu_torch")
    os.makedirs(d, exist_ok=True)
    return d


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels are built from "
        "source at first use."
    )


def _nvcc_version(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[-1]


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; raises on failure.

    The compiler's ``-Xptxas -v`` report (registers, spills) is kept in
    ``BUILD_LOG[name]`` for the build that ran in this process. No lock is
    held while ``nvcc`` runs, so calls from several threads build several
    libraries at once; each build writes its own temporary file and moves
    it into place atomically.
    """
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
    src = os.path.join(_CSRC, f"{name}.cu")
    nvcc = find_nvcc()
    with open(src, "rb") as f:
        key = hashlib.sha256(
            f.read() + repr(NVCC_FLAGS).encode()
            + _nvcc_version(nvcc).encode()
        ).hexdigest()[:16]
    so_path = os.path.join(build_dir(), f"{name}_{key}.so")
    if not os.path.exists(so_path):
        tmp = f"{so_path}.tmp{os.getpid()}_{threading.get_ident()}"
        cmd = [nvcc, *NVCC_FLAGS, src, "-o", tmp]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=600)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src} (exit {res.returncode}):\n"
                    f"{res.stderr}"
                )
            BUILD_LOG[name] = res.stderr
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(so_path)
    with _LOCK:
        return _LIBS.setdefault(name, lib)
