"""Where the port's kernels are built and found.

Counterpart of :mod:`cvmatrix_tpu.utils.cache`. The JAX package points
JAX's persistent compilation cache at a directory; the port's compiled
programs are its kernel libraries, built by ``nvcc`` at first launch and
keyed by source, flags and compiler version
(:mod:`cvmatrix_tpu_torch.ops._build`), so the same call points the build
directory there. A library built once in that directory is loaded by every
later process that uses it, on any checkout of the same sources.
"""

from __future__ import annotations

import os
from typing import Optional

from ..ops import _build

__all__ = ["enable_persistent_cache"]


def enable_persistent_cache(cache_dir: Optional[str] = None) -> str:
    """Build and load the kernel libraries under ``cache_dir`` (idempotent).

    ``cache_dir`` defaults to ``$CVMATRIX_TPU_TORCH_CACHE``, else the
    checkout's ``.cache/cvmatrix_tpu_torch`` (where the libraries go when
    this is never called). Returns the directory used. It affects only
    libraries loaded afterwards.
    """
    if cache_dir is None:
        cache_dir = os.environ.get("CVMATRIX_TPU_TORCH_CACHE",
                                   _build.default_build_dir())
    _build.set_build_dir(cache_dir)
    return _build.build_dir()
