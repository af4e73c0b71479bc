"""Dataset-wide precompute (the "fit" step), PyTorch port.

Counterpart of :func:`cvmatrix_tpu.core.fit.fit`. The two global products
``XTX = WX^T X`` and ``XTY = WX^T Y`` are one GEMM over ``[X | Y]`` so that
``WX`` is read once. The JAX package routes that contraction through its
exact int8-slice path on the TPU, and a float32 one at
``Precision.HIGHEST``; the port runs it as one native ``torch.matmul`` in
the config dtype, a float32 one in full float32 whatever the process's
TF32 setting (:func:`~cvmatrix_tpu_torch.ops.precision.highest_precision`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import CVConfig
from ..ops.precision import highest_precision
from ..utils.profiling import FIT, spanned
from .state import FitState

__all__ = ["fit", "default_device"]


def default_device(X, device=None) -> torch.device:
    """Where an entry point runs: ``device`` when given, else a tensor
    ``X``'s device, else the CUDA card. Without a card that last case
    raises: the port never falls back to the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if isinstance(X, torch.Tensor):
        return X.device
    if not torch.cuda.is_available():
        raise ValueError(
            "no CUDA card: torch.cuda.is_available() is false. The port runs "
            "on the card by default; pass device='cpu' to run on the CPU."
        )
    return torch.device("cuda")


def _shares_memory(t: torch.Tensor, src) -> bool:
    if isinstance(src, torch.Tensor):
        return t.device == src.device and t.data_ptr() == src.data_ptr()
    if isinstance(src, np.ndarray):
        return t.device.type == "cpu" and t.data_ptr() == src.ctypes.data
    return False


def _init_mat(mat, dtype: torch.dtype, device, copy: bool) -> torch.Tensor:
    """Cast to dtype on ``device`` and promote 1-D inputs to a column.

    ``torch.as_tensor`` shares memory with a NumPy array or tensor that
    already has the dtype and device; ``copy=True`` (the reference's knob)
    then clones, so later writes to the caller's buffer cannot reach the
    fitted state.
    """
    t = torch.as_tensor(mat, dtype=dtype, device=device)
    if copy and _shares_memory(t, mat):
        t = t.clone()
    if t.ndim == 1:
        t = t.reshape(-1, 1)
    return t


@spanned(FIT)
def fit(
    config: CVConfig,
    X,
    Y=None,
    weights: Optional[object] = None,
    *,
    validate: bool = True,
    copy: bool = True,
    device=None,
) -> FitState:
    """Compute the dataset-wide products and statistics.

    Inputs may be NumPy arrays or tensors; everything lands on ``device``
    (default: ``X``'s device for a tensor, else the CUDA card, see
    :func:`default_device`). Raises ``ValueError`` for negative weights
    unless ``validate=False``.
    """
    device = default_device(X, device)
    dtype = config.torch_dtype
    X = _init_mat(X, dtype, device, copy)
    Y_arr = None if Y is None else _init_mat(Y, dtype, device, copy)
    w = None if weights is None else _init_mat(weights, dtype, device, copy)

    if w is not None and validate and bool((w < 0).any()):
        raise ValueError("Weights must be non-negative.")

    # Weighted matrices. Unweighted: aliases, no copies.
    if w is None:
        WX = X
        WY = Y_arr
    else:
        WX = X * w
        WY = Y_arr * w if (Y_arr is not None and config.needs_WY) else None

    k = X.shape[1]
    with highest_precision():
        if Y_arr is not None:
            prod = torch.matmul(WX.T, torch.cat([X, Y_arr], dim=1))
            XTX, XTY = prod[:, :k], prod[:, k:]
        else:
            XTX, XTY = torch.matmul(WX.T, X), None

    n = X.shape[0]
    sum_w = num_nonzero_w = None
    if config.any_stats:
        if w is not None:
            sum_w = w.sum()
            num_nonzero_w = torch.count_nonzero(w)
        else:
            sum_w = torch.tensor(n, dtype=dtype, device=device)
            num_nonzero_w = torch.tensor(n, dtype=torch.int64, device=device)
    sum_X = WX.sum(dim=0, keepdim=True) if config.needs_sum_X else None
    sum_Y = (
        WY.sum(dim=0, keepdim=True)
        if (config.needs_sum_Y and Y_arr is not None) else None
    )
    sum_sq_X = (WX * X).sum(dim=0, keepdim=True) if config.scale_X else None
    sum_sq_Y = (
        (WY * Y_arr).sum(dim=0, keepdim=True)
        if (config.scale_Y and Y_arr is not None) else None
    )

    return FitState(
        X=X, WX=WX, Y=Y_arr, WY=WY, weights=w,
        XTX=XTX, XTY=XTY,
        sum_X=sum_X, sum_Y=sum_Y, sum_sq_X=sum_sq_X, sum_sq_Y=sum_sq_Y,
        sum_w=sum_w, num_nonzero_w=num_nonzero_w,
    )
