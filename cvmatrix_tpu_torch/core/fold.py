"""Per-fold training-matrix computation, PyTorch port.

Counterpart of :mod:`cvmatrix_tpu.core.fold`, the reference-shaped per-fold
engine in plain torch: gather the validation rows, downdate the global
products and statistics, then centre and scale. It is the ``impl="torch"``
route of the port and the base its LOOCV kernel is tested against.

Every function takes the validation indices as ``(L,)`` for one fold or
``(F, L)`` for a batch of equal-size folds (the counterpart of the JAX
package's ``vmap``); statistics then carry the same leading fold axis.
Torch runs eagerly, so the data-dependent checks always run.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import CVConfig
from ..ops.precision import highest_precision
from .state import FitState

__all__ = [
    "FoldBlocks",
    "gather_val_blocks",
    "training_matrices_from_blocks",
    "training_matrices",
    "training_XTX",
    "training_XTY",
    "training_XTX_XTY",
    "training_statistics",
]


class FoldBlocks(NamedTuple):
    """Gathered validation rows.

    ``Xv_w`` rows are weighted (``WX[v]``) and mask-zeroed; ``Xv_u`` rows are
    unweighted and unmasked (they alias the same gather when weights are
    absent). ``w_val`` is ``None`` for unweighted data; ``mask`` is ``None``
    or 0/1 in the config dtype.
    """

    Xv_w: torch.Tensor
    Xv_u: torch.Tensor
    Yv_w: Optional[torch.Tensor]
    Yv_u: Optional[torch.Tensor]
    w_val: Optional[torch.Tensor]
    mask: Optional[torch.Tensor]


def _as_index(val_indices, n: int, device) -> torch.Tensor:
    """Validation indices as int64 on ``device``; out-of-range raises.

    Follows NumPy's (the reference's) eager rule: ``[-n, n)`` is valid,
    negatives wrap. A CUDA gather out of range would fault the device.
    """
    v = torch.as_tensor(val_indices, device=device)
    if v.dtype not in (torch.int64, torch.int32, torch.int16, torch.uint8,
                       torch.int8):
        raise TypeError(f"validation indices must be integers, got {v.dtype}")
    v = v.to(torch.int64)
    if v.numel():
        lo, hi = (int(x) for x in torch.aminmax(v))
        if lo < -n or hi >= n:
            raise IndexError(
                f"validation indices out of range for {n} samples "
                f"(min {lo}, max {hi})."
            )
    return v


def gather_val_blocks(
    config: CVConfig, state: FitState, v, mask, return_XTY: bool
) -> FoldBlocks:
    """Row-gather the validation block."""
    if mask is not None:
        # A f64 mask must not promote an f32 config's fold math to f64.
        mask = torch.as_tensor(mask, dtype=config.torch_dtype,
                               device=state.device)
    Xv_raw = state.WX[v]
    Xv_u = Xv_raw if state.weights is None else state.X[v]
    Xv_w = Xv_raw if mask is None else Xv_raw * mask[..., None]
    if return_XTY:
        # Y_val is the *unweighted* gather when weights are absent or no Y
        # statistics are ever needed (the reference's aliasing rule).
        if state.weights is None or not config.needs_WY:
            Yv_raw = state.Y[v]
            Yv_u = Yv_raw
        else:
            Yv_raw = state.WY[v]
            Yv_u = state.Y[v]
        Yv_w = Yv_raw if mask is None else Yv_raw * mask[..., None]
    else:
        Yv_w = Yv_u = None
    if state.weights is None:
        w_val = None
    else:
        w_val = state.weights[v]
        if mask is not None:
            w_val = w_val * mask[..., None]
    return FoldBlocks(Xv_w, Xv_u, Yv_w, Yv_u, w_val, mask)


def _train_weight_scalars(state: FitState, blocks: FoldBlocks, *,
                          check: bool = True):
    """Training-set weight sum and nonzero count, shaped to broadcast
    against ``(..., 1, K)`` row vectors. ``check=False`` skips the
    device-syncing validity raise (the kernel routes' rule, as the JAX
    package's traced path)."""
    if blocks.w_val is None:
        if blocks.mask is None:
            sum_w_val = blocks.Xv_w.shape[-2]
        else:
            sum_w_val = blocks.mask.sum(dim=-1)[..., None, None]
        sum_w_train = state.sum_w - sum_w_val
        num_nonzero_w_train = sum_w_train
    else:
        sum_w_train = state.sum_w - blocks.w_val.sum(dim=(-2, -1),
                                                     keepdim=True)
        num_nonzero_w_train = state.num_nonzero_w - (
            blocks.w_val != 0
        ).sum(dim=(-2, -1), keepdim=True)
    if check and bool((num_nonzero_w_train == 0).any()):
        raise ValueError(
            "The number of non-zero weights in the training set must be "
            "greater than zero."
        )
    return sum_w_train, num_nonzero_w_train


def _std_divisor(config: CVConfig, sum_w_train, num_nonzero_w_train, *,
                 check: bool = True):
    if check and bool((num_nonzero_w_train <= config.ddof).any()):
        raise ValueError(
            "The number of non-zero weights in the training set must be "
            "greater than `ddof`."
        )
    return (num_nonzero_w_train - config.ddof) * sum_w_train / num_nonzero_w_train


def _train_std(config: CVConfig, sum_sq_train, mean, sum_train, sum_w_train,
               divisor):
    """One-pass std identity plus the degenerate clamp.

    ``var = (-2 mean . sum + sum_w mean^2 + sum_sq) / divisor``; variance is
    clamped at 0 and stds <= resolution become 1.
    """
    var = (-2 * mean * sum_train + sum_w_train * mean**2 + sum_sq_train) / divisor
    std = torch.sqrt(torch.clamp(var, min=0))
    return torch.where(std <= config.resolution, torch.ones_like(std), std)


def _compute_training_stats(
    config: CVConfig,
    state: FitState,
    blocks: FoldBlocks,
    *,
    return_X_mean: bool,
    return_X_std: bool,
    return_Y_mean: bool,
    return_Y_std: bool,
    check: bool = True,
    val_sums=None,
):
    """Downdated training means/stds: ``(X_mean, X_std, Y_mean, Y_std,
    sum_w_train)`` with ``None`` for statistics not requested.

    ``val_sums``, if given, is ``(sum_X_val, sum_sq_X_val, sum_Y_val,
    sum_sq_Y_val)``, the validation rows' sums already reduced to (..., 1,
    width) (``None`` where unused); the blocks then only supply the
    weights, the mask and the fold size.
    """
    if not (return_X_mean or return_X_std or return_Y_mean or return_Y_std):
        return None, None, None, None, None
    if val_sums is None:
        val_sums = (
            blocks.Xv_w.sum(dim=-2, keepdim=True)
            if (return_X_mean or return_X_std) else None,
            (blocks.Xv_w * blocks.Xv_u).sum(dim=-2, keepdim=True)
            if return_X_std else None,
            blocks.Yv_w.sum(dim=-2, keepdim=True)
            if (return_Y_mean or return_Y_std) else None,
            (blocks.Yv_w * blocks.Yv_u).sum(dim=-2, keepdim=True)
            if return_Y_std else None,
        )
    sum_X_val, sum_sq_X_val, sum_Y_val, sum_sq_Y_val = val_sums
    sum_w_train, num_nonzero_w_train = _train_weight_scalars(state, blocks,
                                                             check=check)
    X_mean = X_std = Y_mean = Y_std = None
    sum_X_train = sum_Y_train = None
    if return_X_mean or return_X_std:
        sum_X_train = state.sum_X - sum_X_val
        X_mean = sum_X_train / sum_w_train
    if return_Y_mean or return_Y_std:
        sum_Y_train = state.sum_Y - sum_Y_val
        Y_mean = sum_Y_train / sum_w_train
    if return_X_std or return_Y_std:
        divisor = _std_divisor(config, sum_w_train, num_nonzero_w_train,
                               check=check)
    if return_X_std:
        X_std = _train_std(config, state.sum_sq_X - sum_sq_X_val, X_mean,
                           sum_X_train, sum_w_train, divisor)
    if return_Y_std:
        Y_std = _train_std(config, state.sum_sq_Y - sum_sq_Y_val, Y_mean,
                           sum_Y_train, sum_w_train, divisor)
    return (
        X_mean if return_X_mean else None,
        X_std if return_X_std else None,
        Y_mean if return_Y_mean else None,
        Y_std if return_Y_std else None,
        sum_w_train,
    )


def _apply_epilogue(T, mean1, mean2, std1, std2, sum_w_train, center: bool):
    """Rank-one centre plus outer-product scale."""
    if center:
        T = T - sum_w_train * (mean1.mT * mean2)
    if std1 is not None and std2 is not None:
        return T / (std1.mT * std2)
    if std1 is not None:
        return T / std1.mT
    if std2 is not None:
        return T / std2
    return T


@highest_precision()
def training_matrices_from_blocks(
    config: CVConfig,
    state: FitState,
    blocks: FoldBlocks,
    *,
    return_XTX: bool = True,
    return_XTY: bool = True,
):
    """Fold math given already-gathered validation blocks; float32
    products in full float32."""
    # The XTY mean cross-term cancels only when both sides are centred, so
    # one-sided centring still needs the other side's mean.
    X_mean, X_std, Y_mean, Y_std, sum_w_train = _compute_training_stats(
        config,
        state,
        blocks,
        return_X_mean=config.center_X or (return_XTY and config.center_Y),
        return_X_std=config.scale_X,
        return_Y_mean=return_XTY and (config.center_X or config.center_Y),
        return_Y_std=return_XTY and config.scale_Y,
    )
    stats = (X_mean, X_std, Y_mean, Y_std)
    center_xty = config.center_X or config.center_Y

    if return_XTX and return_XTY:
        # One product over [X_val | Y_val], split into the two downdates.
        m2 = torch.cat([blocks.Xv_u, blocks.Yv_u], dim=-1)
        prod = blocks.Xv_w.mT @ m2
        k = blocks.Xv_u.shape[-1]
        xtx = _apply_epilogue(state.XTX - prod[..., :k], X_mean, X_mean,
                              X_std, X_std, sum_w_train, center=config.center_X)
        xty = _apply_epilogue(state.XTY - prod[..., k:], X_mean, Y_mean,
                              X_std, Y_std, sum_w_train, center=center_xty)
        return (xtx, xty), stats
    if return_XTX:
        prod = blocks.Xv_w.mT @ blocks.Xv_u
        xtx = _apply_epilogue(state.XTX - prod, X_mean, X_mean, X_std, X_std,
                              sum_w_train, center=config.center_X)
        return xtx, stats
    prod = blocks.Xv_w.mT @ blocks.Yv_u
    xty = _apply_epilogue(state.XTY - prod, X_mean, Y_mean, X_std, Y_std,
                          sum_w_train, center=center_xty)
    return xty, stats


def training_matrices(
    config: CVConfig,
    state: FitState,
    val_indices,
    mask=None,
    *,
    return_XTX: bool = True,
    return_XTY: bool = True,
):
    """Training-set ``X^T W X`` and/or ``X^T W Y`` for one fold (or a batch).

    Returns ``(mat | (XTX, XTY), (X_mean, X_std, Y_mean, Y_std))``.
    """
    if not return_XTX and not return_XTY:
        raise ValueError(
            "At least one of `return_XTX` and `return_XTY` must be True."
        )
    if return_XTY and state.Y is None:
        raise ValueError("Response variables `Y` are not provided.")
    v = _as_index(val_indices, state.N, state.device)
    blocks = gather_val_blocks(config, state, v, mask, return_XTY)
    return training_matrices_from_blocks(
        config, state, blocks, return_XTX=return_XTX, return_XTY=return_XTY,
    )


def training_XTX(config: CVConfig, state: FitState, val_indices, mask=None):
    return training_matrices(config, state, val_indices, mask,
                             return_XTX=True, return_XTY=False)


def training_XTY(config: CVConfig, state: FitState, val_indices, mask=None):
    return training_matrices(config, state, val_indices, mask,
                             return_XTX=False, return_XTY=True)


def training_XTX_XTY(config: CVConfig, state: FitState, val_indices,
                     mask=None):
    return training_matrices(config, state, val_indices, mask,
                             return_XTX=True, return_XTY=True)


def training_statistics(
    config: CVConfig, state: FitState, val_indices, mask=None
) -> Tuple:
    """Training means/stds only.

    The flag set differs from :func:`training_matrices`: the X mean is
    returned when ``center_X or scale_X``; the Y mean when
    ``(center_Y or scale_Y)`` and Y is present.
    """
    v = _as_index(val_indices, state.N, state.device)
    has_Y = state.Y is not None
    need_y_stats = (config.center_Y or config.scale_Y) and has_Y
    blocks = gather_val_blocks(config, state, v, mask, return_XTY=need_y_stats)
    return _compute_training_stats(
        config,
        state,
        blocks,
        return_X_mean=config.center_X or config.scale_X,
        return_X_std=config.scale_X,
        return_Y_mean=need_y_stats,
        return_Y_std=config.scale_Y and has_Y,
    )[:-1]
