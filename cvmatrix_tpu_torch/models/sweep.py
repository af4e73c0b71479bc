"""Materialising fold sweeps, PyTorch port.

Counterpart of ``materialize_sweep`` and ``materialize_cv`` in
:mod:`cvmatrix_tpu.models.sweep`: compute EVERY fold's training matrices in
device memory, chunk by chunk into one reused buffer, and return a probe
scalar. The chunk size follows the JAX package's rule (a 4 GB budget, at
most 2000 folds, chunks equalised and the last fold repeated to fill the
last chunk).

Every fold batch, float64 or float32, takes the kernel route that
:func:`~cvmatrix_tpu_torch.core.batch.route_kernel` picks by the JAX
package's gates: the hand-written kernel on CUDA, its plain twin on the CPU
or with ``impl="torch"``. The LOOCV, packed (both dtypes) and v3 routes
build their operands once for all folds and slice them per chunk; the
large-fold routes (Ozaki-df64, ``bmm`` plus epilogue, and the float32
engine's ``fused_downdate``) gather and reduce chunk by chunk (hoisting
L-row blocks for every fold would hold the whole dataset twice). A
float32 sweep computes and writes float32; the chunk rule budgets 8 bytes
per element in either dtype, as the JAX package's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import CVConfig
from ..core.batch import (
    _f32_kernel_path,
    _large_fold_path,
    _rows_mask,
    downdate_from_operands,
    loocv_from_sources,
    ozaki_v3_from_sources,
    prepare_fold_operands,
    prepare_loocv_sources,
    prepare_ozaki_sources,
    route_kernel,
    slice_operands,
)
from ..core.fit import fit
from ..core.state import FitState
from ..ops.loocv import IMPLS, check_rows

__all__ = ["chunking", "materialize_cv", "materialize_sweep"]


def chunking(n_folds: int, k: int, c: int, batch_size: Optional[int] = None,
             hbm_budget_bytes: float = 4e9) -> Tuple[int, int]:
    """``(bs, n_chunks)``: the JAX package's chunk rule for (K, C) outputs."""
    if batch_size is None:
        per_fold = 2 * 8 * max(k * c, 1)
        batch_size = max(1, min(2000, int(hbm_budget_bytes / per_fold)))
    bs = min(batch_size, n_folds)
    n_chunks = -(-n_folds // bs)
    bs = -(-n_folds // n_chunks)
    return bs, n_chunks


def _pad_folds(idx, mask, bs):
    """Pad the fold axis to a multiple of ``bs`` by repeating the last fold."""
    pad = (-idx.shape[0]) % bs
    if pad:
        idx = np.concatenate([idx, np.repeat(idx[-1:], pad, axis=0)])
        if mask is not None:
            mask = np.concatenate([mask, np.repeat(mask[-1:], pad, axis=0)])
    return idx, mask


def materialize_sweep(
    config: CVConfig,
    state: FitState,
    idx_batch,
    mask_batch=None,
    *,
    batch_size: Optional[int] = None,
    impl: str = "auto",
    return_XTX: bool = True,
    return_XTY: bool = True,
    hbm_budget_bytes: float = 4e9,
) -> torch.Tensor:
    """Produce every fold's training matrices on the state's device.

    ``idx_batch`` is an (F, L) fold-index batch (or (F,) for one-row folds),
    ``mask_batch`` an optional (F, L) 0/1 mask. Returns a 0-d tensor on the
    device: element [0, 0] of XTX plus element [0, 0] of XTY of the last
    chunk's first fold (what the JAX package's sweep returns). Reading it
    waits for the whole sweep.
    """
    if impl not in IMPLS:
        raise ValueError(f"Unknown impl: {impl!r} (auto|cuda|torch).")
    if not return_XTX and not return_XTY:
        raise ValueError(
            "At least one of `return_XTX` and `return_XTY` must be True."
        )
    if return_XTY and state.Y is None:
        raise ValueError("Response variables `Y` are not provided.")
    device = state.device
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors; the state is on "
                         f"{device}.")
    idx = np.asarray(idx_batch.cpu() if isinstance(idx_batch, torch.Tensor)
                     else idx_batch)
    if idx.ndim == 1:
        idx = idx[:, None]
    mask = None if mask_batch is None else np.asarray(mask_batch)
    k = state.K
    m = (state.M or 0) if return_XTY else 0
    bs, n_chunks = chunking(idx.shape[0], k, (k if return_XTX else 0) + m,
                            batch_size, hbm_budget_bytes)
    idx, mask = _pad_folds(idx, mask, bs)

    route = route_kernel(config, state, idx.shape[1], return_XTX,
                         return_XTY, mask is not None)
    buf = torch.empty((bs, k, (k if return_XTX else 0) + m),
                      dtype=config.torch_dtype, device=device)
    if route == "loocv":
        rows = check_rows(idx[:, 0], state.N)
        if device.type == "cuda":
            rows = rows.pin_memory()  # asynchronous per-chunk copies
        src = prepare_loocv_sources(config, state, rows,
                                    return_XTX=return_XTX,
                                    return_XTY=return_XTY)
        for c in range(n_chunks):
            sl = slice(c * bs, (c + 1) * bs)
            loocv_from_sources(config, src, rows[sl], src.scal[sl],
                               return_XTY=return_XTY, impl=impl, out=buf)
    else:
        # Checked on the host once, then moved whole to the device.
        rows, mask_d = _rows_mask(config, state, torch.as_tensor(idx), mask)
        if route in ("packed", "packed_f32"):
            ops, _ = prepare_fold_operands(config, state, rows, mask_d,
                                           return_XTX=return_XTX,
                                           return_XTY=return_XTY)
            for c in range(n_chunks):
                downdate_from_operands(slice_operands(ops, c * bs, bs),
                                       impl=impl, out=buf)
        elif route == "v3":
            src = prepare_ozaki_sources(config, state, rows, mask_d,
                                        return_XTX=return_XTX,
                                        return_XTY=return_XTY)
            for c in range(n_chunks):
                ozaki_v3_from_sources(config, slice_operands(src, c * bs, bs),
                                      return_XTY=return_XTY, impl=impl,
                                      out=buf)
        else:
            large = (_f32_kernel_path if route == "downdate_f32"
                     else _large_fold_path)
            for c in range(n_chunks):
                sl = slice(c * bs, (c + 1) * bs)
                large(config, state, rows[sl],
                      None if mask_d is None else mask_d[sl],
                      return_XTX=return_XTX, return_XTY=return_XTY,
                      impl=impl, out=buf)
    if return_XTX and return_XTY:
        return buf[0, 0, 0] + buf[0, 0, k]
    return buf[0, 0, 0]


def materialize_cv(
    config: CVConfig,
    X,
    Y=None,
    weights=None,
    idx_batch=None,
    mask_batch=None,
    *,
    batch_size: Optional[int] = None,
    impl: str = "auto",
    return_XTX: bool = True,
    return_XTY: bool = True,
    hbm_budget_bytes: float = 4e9,
    validate: bool = True,
    device=None,
) -> torch.Tensor:
    """Fit plus the full fold sweep; returns :func:`materialize_sweep`'s probe.

    The total cross-validation quantity: one fit and every fold's training
    matrices. ``validate=False`` skips the (device-syncing) negative-weight
    check. The fitted state may share memory with tensor inputs (no copy).
    """
    state = fit(config, X, Y, weights, validate=validate, copy=False,
                device=device)
    return materialize_sweep(
        config, state, idx_batch, mask_batch, batch_size=batch_size,
        impl=impl, return_XTX=return_XTX, return_XTY=return_XTY,
        hbm_budget_bytes=hbm_budget_bytes,
    )
