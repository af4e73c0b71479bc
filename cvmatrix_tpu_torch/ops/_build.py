"""Build-on-first-use loader for the port's CUDA kernels.

Each ``.cu`` file under ``cvmatrix_tpu_torch/csrc/`` exposes a plain C
interface. It is compiled by ``nvcc`` for ``sm_90a`` (Hopper) into a shared
library under :func:`build_dir` the first time a kernel is launched, keyed by
a hash of the source, the flags and the compiler's version, and loaded with
``ctypes``. Nothing is built or loaded at import time. A failed build raises:
there is no fallback.

:func:`~cvmatrix_tpu_torch.utils.cache.enable_persistent_cache` moves the
build directory; :func:`~cvmatrix_tpu_torch.utils.aot.load_kernels` makes
:func:`load_library` load shipped libraries instead of building them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional, Tuple

__all__ = ["NVCC_FLAGS", "build_dir", "default_build_dir", "find_nvcc",
           "kernel_key", "library_names", "library_path", "load_library",
           "set_build_dir"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}
# set by enable_persistent_cache; None keeps default_build_dir()
_BUILD_DIR: Optional[str] = None
# name -> shipped library path, set by load_kernels
_SHIPPED: Dict[str, str] = {}


def default_build_dir() -> str:
    """``<checkout>/.cache/cvmatrix_tpu_torch`` (ignored by git)."""
    return os.path.join(os.path.dirname(_PKG), ".cache", "cvmatrix_tpu_torch")


def set_build_dir(path: str) -> None:
    """Build and look up libraries under ``path`` from now on."""
    global _BUILD_DIR
    _BUILD_DIR = os.path.abspath(path)


def build_dir() -> str:
    """The build directory: the one :func:`set_build_dir` set, else
    :func:`default_build_dir`."""
    d = _BUILD_DIR or default_build_dir()
    os.makedirs(d, exist_ok=True)
    return d


def library_names() -> Tuple[str, ...]:
    """Every kernel source of the checkout, ``csrc/<name>.cu``."""
    return tuple(sorted(f[:-3] for f in os.listdir(_CSRC)
                        if f.endswith(".cu")))


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


def nvcc_version(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[-1]


def kernel_key(name: str, version: str) -> str:
    """The build key of ``csrc/<name>.cu``: its source, :data:`NVCC_FLAGS`
    and the compiler's ``version`` line."""
    with open(os.path.join(_CSRC, f"{name}.cu"), "rb") as f:
        return hashlib.sha256(f.read() + repr(NVCC_FLAGS).encode()
                              + version.encode()).hexdigest()[:16]


def library_path(name: str) -> Tuple[str, str, str]:
    """Build ``csrc/<name>.cu`` unless its library is in :func:`build_dir`;
    returns ``(path, key, nvcc version)``. Raises on a failed build.

    The compiler's ``-Xptxas -v`` report (registers, spills) is kept in
    ``BUILD_LOG[name]`` for the build that ran in this process. No lock is
    held while ``nvcc`` runs, so calls from several threads build several
    libraries at once; each build writes its own temporary file and moves
    it into place atomically.
    """
    src = os.path.join(_CSRC, f"{name}.cu")
    nvcc = find_nvcc()
    version = nvcc_version(nvcc)
    key = kernel_key(name, version)
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
    return so_path, key, version


def load_library(name: str) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu``'s library: the shipped one where
    :func:`~cvmatrix_tpu_torch.utils.aot.load_kernels` named it (no
    ``nvcc`` needed), else built by :func:`library_path`; raises on failure.
    """
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        shipped = _SHIPPED.get(name)
    lib = ctypes.CDLL(shipped or library_path(name)[0])
    with _LOCK:
        return _LIBS.setdefault(name, lib)
