"""The mantissa slicer: plain PyTorch twin, CUDA kernel wrapper, dispatch.

Counterpart of the JAX package's ``slice_rows`` (``cvmatrix_tpu/ops/
kernels.py``; its math is ``_slice_rows_math``): the f32 (hi, lo) pair rows
``xh + xl`` of an (N, K) pair of planes, scaled per column by the exact
powers of two ``pows[0] * pows[1]``, cut into ``n_slices`` int8 slices of
``_OZAKI_T_BITS`` = 6 bits each. Per round both halves are multiplied by
2^6, ``q0 = round(r_h)`` (ties to even), ``adj = round((r_h - q0) + r_l)``,
``q0 + adj`` is emitted and ``two_sum((r_h - q0) - adj, r_l)`` carries the
rest, so the slices stay within [-65, 65] and the decomposition is exact to
the slice budget. The result is an integer, so kernel and twin agree bit for
bit. Kernel: ``csrc/slice_rows.cu`` (``cvm_slice_rows_f32``).

:func:`slice_rows` dispatches like the other wrappers of the port:
``impl="auto"`` launches the kernel for CUDA tensors and runs
:func:`slice_rows_reference` for CPU tensors; ``"cuda"`` always launches;
``"torch"`` always runs the twin. ``slice_rows.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from .fold_downdate import _check, _fn, _out, _run, _use_kernel
from .loocv import _ptr

__all__ = ["slice_rows_reference", "slice_rows", "launch_counts",
           "reset_launch_counts"]

# Bits per slice: the JAX package's precise._T_BITS (core/batch.py keeps
# the same value for its gates).
_OZAKI_T_BITS = 6


def _two_sum(a, b):
    """Knuth's exact addition: ``a + b == s + e`` exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def slice_rows_reference(xh, xl, pows, *, n_slices: int = 10,
                         row_major: bool = True) -> torch.Tensor:
    """``_slice_rows_math`` in float32, op by op in its order -> int8
    (N, S, K) if ``row_major`` else (S, N, K)."""
    p1, p2 = pows[0:1], pows[1:2]
    r_h = xh * p1 * p2
    r_l = xl * p1 * p2
    mul = float(1 << _OZAKI_T_BITS)
    out = []
    for _ in range(n_slices):
        r_h = r_h * mul
        r_l = r_l * mul
        q0 = torch.round(r_h)  # ties to even, as jnp.round
        adj = torch.round((r_h - q0) + r_l)
        out.append((q0 + adj).to(torch.int8))
        r_h, r_l = _two_sum(r_h - q0 - adj, r_l)
    return torch.stack(out, dim=1 if row_major else 0)


def _check_shapes(xh, xl, pows, block_rows):
    n, k = xh.shape
    if n % block_rows:
        raise ValueError(f"N={n} not a multiple of block_rows={block_rows}")
    if tuple(xl.shape) != (n, k) or tuple(pows.shape) != (2, k):
        raise ValueError(f"slice_rows: xh {tuple(xh.shape)}, xl "
                         f"{tuple(xl.shape)} and pows {tuple(pows.shape)} "
                         "must be (N, K), (N, K) and (2, K).")


def slice_rows(xh, xl, pows, *, n_slices: int = 10, row_major: bool = True,
               block_rows: int = 256, impl: str = "auto",
               out=None) -> torch.Tensor:
    """Mantissa slices of pair rows -> int8 (N, S, K), or (S, N, K) when
    ``row_major`` is False.

    ``xh``, ``xl`` are the (N, K) float32 hi and lo planes, ``pows`` the
    (2, K) float32 power-of-two factors. N must be a multiple of
    ``block_rows``, as in the JAX function (the TPU kernel's row block),
    so both packages accept and reject the same inputs; the CUDA grid does
    not use it. ``out``, when given, is a contiguous int8 tensor of the
    result's shape that receives it.
    """
    _check_shapes(xh, xl, pows, block_rows)
    n, k = xh.shape
    shape = (n, n_slices, k) if row_major else (n_slices, n, k)
    device = xh.device
    if not _use_kernel("slice_rows", impl, device):
        res = slice_rows_reference(xh, xl, pows, n_slices=n_slices,
                                   row_major=row_major)
        return res if out is None else out.copy_(res)
    _check("slice_rows", device, (xh, xl, pows), torch.float32)
    out = _out("slice_rows", out, shape, device, torch.int8)
    fn = _fn("slice_rows", "cvm_slice_rows_f32", 4, 2,
             tail=(ctypes.c_int, ctypes.c_int))
    _run("slice_rows", fn, _ptr(xh), _ptr(xl), _ptr(pows), _ptr(out), n, k,
         n_slices, int(row_major), device=device)
    slice_rows.launches += 1
    return out


def reset_launch_counts() -> None:
    slice_rows.launches = 0


def launch_counts() -> dict:
    """``{kernel: launches}`` of the slicer."""
    return {"slice_rows": slice_rows.launches}


reset_launch_counts()
