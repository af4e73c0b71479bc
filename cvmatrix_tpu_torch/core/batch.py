"""Batched leave-one-out operands and the LOOCV kernel route, PyTorch port.

Counterpart of the LOOCV part of :mod:`cvmatrix_tpu.core.batch`
(``loocv_single_tile_ok``, ``_fold_scalar_stream``, ``prepare_loocv_sources``,
``loocv_from_sources``). The JAX package packs these operands as padded
f32 (hi, lo) pairs for its TPU kernel; the port keeps them as unpadded
tensors in the config dtype, which the H100 kernel reads directly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import CVConfig
from ..ops import loocv as _loocv
from .state import FitState

__all__ = [
    "LoocvSources",
    "loocv_single_tile_ok",
    "prepare_loocv_sources",
    "loocv_from_sources",
    "unported_kernel",
]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class LoocvSources(NamedTuple):
    """Dataset-wide operands of the LOOCV kernel plus the per-fold scalars.

    ``total`` is ``[XTX | XTY]`` (K, C); ``xw`` the weighted X rows (X when
    unweighted) and ``xu`` the unweighted ones (they alias when unweighted);
    ``yw``/``yu`` likewise for Y under the reference's aliasing rule
    (``None`` without the XTY side); ``gx``/``gy`` are (2, K)/(2, M):
    global sums and sums of squares, zeros where unused. ``scal`` is the
    (F, 3) per-fold ``[sw_train, 1/sw_train, 1/divisor]`` stream.
    """

    total: torch.Tensor
    xw: torch.Tensor
    xu: torch.Tensor
    yu: Optional[torch.Tensor]
    yw: Optional[torch.Tensor]
    gx: torch.Tensor
    gy: Optional[torch.Tensor]
    scal: torch.Tensor


def loocv_single_tile_ok(config: CVConfig, state: FitState, return_XTX: bool,
                         return_XTY: bool) -> bool:
    """Whether the LOOCV kernel route applies.

    Keeps the JAX package's geometry so that both packages route the same
    folds the same way: the XTX side present, and ``[X | Y]`` fitting one
    square 128-padded tile of at most 1024 columns.
    """
    if not return_XTX:
        return False
    k = state.K
    c = k + ((state.M or 0) if return_XTY else 0)
    kp = _round_up(max(k, 8), 128)
    cp = _round_up(max(c, 8), 128)
    return kp == cp and cp <= 1024


def unported_kernel(state: FitState, n_l: int, return_XTY: bool) -> str:
    """The TPU kernel the JAX package routes a non-LOOCV fold batch to,
    none of which has a CUDA port yet (named in NotImplementedError)."""
    c = state.K + ((state.M or 0) if return_XTY else 0)
    if n_l < 10:
        return "fused_downdate_df64_packed (cvmatrix_tpu/ops/kernels.py:382)"
    if n_l <= 1024 and c <= 512:
        return "fused_ozaki_downdate_v3 (cvmatrix_tpu/ops/kernels.py:2333)"
    return "fused_epilogue_df64 (cvmatrix_tpu/ops/kernels.py:531)"


def _fold_scalar_stream(config: CVConfig, state: FitState,
                        rows: torch.Tensor) -> torch.Tensor:
    """(F, 3) per-fold ``[sw_train, 1/sw_train, 1/divisor]`` for one-row
    folds: the scalars of ``fold._train_weight_scalars`` and
    ``fold._std_divisor`` with reciprocals taken outside the kernel.
    The divisor stays in floating point (``count_nonzero`` is int64)."""
    dt = config.torch_dtype
    if state.weights is not None:
        wv = state.weights[rows, 0]
        sw_t = state.sum_w - wv
        nnz_t = (state.num_nonzero_w - (wv != 0).to(torch.int64)).to(dt)
    else:
        sw_t = torch.full((rows.shape[0],), state.N - 1, dtype=dt,
                          device=state.device)
        nnz_t = sw_t
    divisor = (nnz_t - config.ddof) * sw_t / nnz_t
    return torch.stack([sw_t, 1.0 / sw_t, 1.0 / divisor], dim=1)


def prepare_loocv_sources(
    config: CVConfig,
    state: FitState,
    idx_batch,
    mask_batch=None,
    *,
    return_XTX: bool = True,
    return_XTY: bool = True,
) -> LoocvSources:
    """Build the operands of the LOOCV kernel for the folds ``idx_batch``
    ((F,) or (F, 1) row indices, checked against ``[0, N)``).

    Folds of more than one row, or with a mask, are the JAX package's
    ``fused_smallfold_df64``, which has no port yet.
    """
    idx = idx_batch if isinstance(idx_batch, torch.Tensor) else np.asarray(
        idx_batch)
    if mask_batch is not None or (idx.ndim > 1 and idx.shape[1] != 1):
        raise NotImplementedError(
            "fused_smallfold_df64 (cvmatrix_tpu/ops/kernels.py:1631), the "
            "masked/multi-row LOOCV kernel, is not ported yet."
        )
    if not loocv_single_tile_ok(config, state, return_XTX, return_XTY):
        raise ValueError(
            f"single-tile geometry required (K={state.K}, M={state.M}); "
            "check loocv_single_tile_ok before preparing sources"
        )
    if return_XTY and state.Y is None:
        raise ValueError("Response variables `Y` are not provided.")
    rows = _loocv.check_rows(idx, state.N).to(state.device)
    weighted = state.weights is not None
    dt = config.torch_dtype
    k = state.K

    def stat_rows(sum_vec, sq_vec, width):
        g = torch.zeros((2, width), dtype=dt, device=state.device)
        if sum_vec is not None:
            g[0] = sum_vec[0]
        if sq_vec is not None:
            g[1] = sq_vec[0]
        return g

    center = config.center_X or (return_XTY and config.center_Y)
    need_x_mean = center or config.scale_X
    need_y_stats = return_XTY and (
        config.center_X or config.center_Y or config.scale_Y
    )
    xw = (state.WX if weighted else state.X).contiguous()
    xu = state.X.contiguous() if weighted else xw
    gx = stat_rows(state.sum_X if need_x_mean else None,
                   state.sum_sq_X if config.scale_X else None, k)
    if return_XTY:
        yu = state.Y.contiguous()
        yw = state.WY.contiguous() if (weighted and need_y_stats) else yu
        gy = stat_rows(state.sum_Y if need_y_stats else None,
                       state.sum_sq_Y if config.scale_Y else None, state.M)
        total = torch.cat([state.XTX, state.XTY], dim=1)
    else:
        yu = yw = gy = None
        total = state.XTX.contiguous()
    scal = (
        _fold_scalar_stream(config, state, rows)
        if (need_x_mean or need_y_stats)
        else torch.zeros((rows.shape[0], 3), dtype=dt, device=state.device)
    )
    return LoocvSources(total, xw, xu, yu, yw, gx, gy, scal)


def loocv_from_sources(config: CVConfig, src: LoocvSources, rows,
                       scal_slice=None, *, return_XTY: bool,
                       impl: str = "auto", out=None) -> torch.Tensor:
    """Run the LOOCV downdate on (a slice of) prepared sources.

    Returns (F, K, C) with ``XTX = out[..., :K]`` and ``XTY = out[..., K:]``.
    ``impl``: ``"auto"`` (the kernel on CUDA, the twin on CPU), ``"cuda"``
    or ``"torch"``.
    """
    return _loocv.fused_loocv(
        src, rows, src.scal if scal_slice is None else scal_slice,
        center_xtx=config.center_X,
        center_xty=config.center_X or config.center_Y,
        scale_x=config.scale_X,
        scale_y=config.scale_Y,
        with_y=return_XTY,
        resolution=config.resolution,
        impl=impl,
        out=out,
    )
