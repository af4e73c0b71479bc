"""Full-float32 products: the port's counterpart of ``Precision.HIGHEST``.

The JAX package computes every float32 contraction in full float32
(``precise.contract`` passes ``precision=jax.lax.Precision.HIGHEST``). A
float32 ``torch.matmul``, ``bmm`` or ``einsum`` instead takes whatever the
process has set globally: after ``torch.set_float32_matmul_precision("high")``
or ``torch.backends.cuda.matmul.allow_tf32 = True`` it runs in TF32 on the
H100, which keeps about three decimal digits. Every product of the port
runs inside :func:`highest_precision`, which turns TF32 off and gives the
caller back its own setting afterwards. The port's CUDA kernels use plain
FP32 FMA and never TF32.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["highest_precision"]


@contextlib.contextmanager
def highest_precision():
    """Run the enclosed products in full float32 (TF32 off), then restore
    the caller's settings. Also a decorator: ``@highest_precision()``.

    Torch keeps the legacy setting (``set_float32_matmul_precision``,
    ``allow_tf32``) beside a per-backend one (``fp32_precision``) and
    refuses to read the legacy one where the caller has set the two apart;
    both are saved, and the legacy one is left at "highest" in that case.
    """
    cuda_mm = torch.backends.cuda.matmul
    cpu_mm = torch.backends.mkldnn.matmul
    saved = (cuda_mm.fp32_precision, cpu_mm.fp32_precision)
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:  # the caller set the legacy and new APIs apart
        legacy = None
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if legacy is not None:
            torch.set_float32_matmul_precision(legacy)
        cuda_mm.fp32_precision, cpu_mm.fp32_precision = saved
