"""Build-on-first-use ctypes loader for the native partition kernel.

Builds the repository's ``csrc/fastpartition.cpp`` (the same source the JAX
package builds) with plain g++ into the port's build directory the first
time it is needed. As in the JAX package, every failure path returns
``None`` and the Partitioner takes its NumPy path: this is host
bookkeeping, and both paths give the same folds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from ..ops._build import build_dir

__all__ = ["native_available", "partition_int64"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "csrc",
    "fastpartition.cpp",
)


def _host_tag() -> str:
    """CPU/compiler identity: the build uses ``-march=native``."""
    try:
        gxx = subprocess.run(["g++", "-dumpfullversion"], capture_output=True,
                             text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        gxx = "unknown"
    return hashlib.sha256(
        f"{platform.machine()}|{platform.processor()}|{gxx}".encode()
    ).hexdigest()[:8]


def _build() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(build_dir(), f"fastpartition_{tag}_{_host_tag()}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        except (OSError, subprocess.SubprocessError):
            return None
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.cvm_partition_i64.restype = ctypes.c_int64
    lib.cvm_partition_i64.argtypes = [i64p, ctypes.c_int64, i64p, i64p, i64p]
    lib.cvm_scatter_i64.restype = None
    lib.cvm_scatter_i64.argtypes = [i64p, ctypes.c_int64, i64p, i64p]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _LIB = _build()
            _TRIED = True
    return _LIB


def native_available() -> bool:
    """True where the native partition library built and loaded (JAX
    ``loader.py:112``)."""
    return _get_lib() is not None


def partition_int64(labels: np.ndarray) -> Optional[Tuple[np.ndarray, list]]:
    """Group row indices by integer label, first-appearance key order.

    Returns ``(keys, [indices_per_key])`` or ``None`` when the native path is
    unavailable (the caller takes its NumPy path).
    """
    lib = _get_lib()
    if lib is None:
        return None
    labels = np.ascontiguousarray(labels, dtype=np.int64)
    n = labels.shape[0]
    ids = np.empty(n, dtype=np.int64)
    keys = np.empty(n, dtype=np.int64)
    counts = np.empty(n, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    nkeys = lib.cvm_partition_i64(
        labels.ctypes.data_as(i64p), n,
        ids.ctypes.data_as(i64p),
        keys.ctypes.data_as(i64p),
        counts.ctypes.data_as(i64p),
    )
    if nkeys < 0:
        return None
    keys = keys[:nkeys]
    counts = counts[:nkeys]
    offsets = np.zeros(nkeys, dtype=np.int64)
    if nkeys > 1:
        np.cumsum(counts[:-1], out=offsets[1:])
    starts = offsets.copy()
    out_indices = np.empty(n, dtype=np.int64)
    lib.cvm_scatter_i64(
        ids.ctypes.data_as(i64p), n,
        offsets.ctypes.data_as(i64p),
        out_indices.ctypes.data_as(i64p),
    )
    groups = [out_indices[starts[i]: starts[i] + counts[i]] for i in range(nkeys)]
    return keys, groups
