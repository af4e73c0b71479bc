"""The plain reference that decides ``correct``: the fit's products and sums
and a fold's training matrices and statistics, recomputed from the
definitions in plain torch.

A frozen copy of the arithmetic of the repository's NumPy oracle
(``tests/oracle.py``: the training rows gathered, weighted mean, weighted
std with divisor ``(nnz - ddof) * sum_w / nnz``, stds at or under the
resolution replaced by 1, then the products of the centred and scaled rows),
written in torch so that it runs on the card in blocks of one fold. It
imports nothing of the program and takes nothing the program made: the
harness hands it the inputs it handed the program. ``dtype`` is the
precision it computes in (float64 is the reference; a lower one is the
control), and every result comes back in float64. TF32 is off.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _col(w: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if w is None else w.reshape(-1, 1)


def fit_rows(X, Y, w, rows, *, dtype=torch.float64) -> Dict[str, torch.Tensor]:
    """Rows ``rows`` of the fit's XTX = (w X)^T X and XTY = (w X)^T Y, and
    its sums: sum_X = sum w x, sum_sq_X = sum w x^2, sum_Y, sum_sq_Y,
    sum_w."""
    _no_tf32()
    X, Y = X.to(dtype), Y.to(dtype)
    w = _col(None if w is None else w.to(dtype))
    WX = X if w is None else X * w
    WY = Y if w is None else Y * w
    r = torch.as_tensor(rows, device=X.device)
    WXr = WX[:, r]
    out = {"XTX": WXr.T @ X, "XTY": WXr.T @ Y,
           "sum_X": WX.sum(0, keepdim=True), "sum_Y": WY.sum(0, keepdim=True),
           "sum_sq_X": (WX * X).sum(0, keepdim=True),
           "sum_sq_Y": (WY * Y).sum(0, keepdim=True),
           "sum_w": (w.sum() if w is not None
                     else torch.tensor(float(X.shape[0]), device=X.device))}
    return {k: v.to(torch.float64) for k, v in out.items()}


def _mean(a, w):
    if w is None:
        return a.mean(0, keepdim=True)
    return (w * a).sum(0, keepdim=True) / w.sum()


def _std(a, mean, w, nnz, ddof: int, resolution: float):
    sum_w = torch.tensor(float(a.shape[0]), dtype=a.dtype,
                         device=a.device) if w is None else w.sum()
    divisor = (nnz - ddof) * sum_w / nnz
    ww = 1.0 if w is None else w
    std = ((ww * (a - mean) ** 2).sum(0, keepdim=True) / divisor).sqrt()
    return torch.where(std.abs() <= resolution, torch.ones_like(std), std)


def fold(X, Y, w, val_rows, cfg: dict, rows=None, *, dtype=torch.float64):
    """Fold training matrices from the training rows (every row but
    ``val_rows``): ``(XTX[rows], XTY[rows], (X_mean, X_std, Y_mean,
    Y_std))``, ``rows`` all when ``None``, each statistic (1, K) or (1, M)
    or ``None`` where the flags do not ask for it, as the oracle returns
    them."""
    _no_tf32()
    n = X.shape[0]
    keep = torch.ones(n, dtype=torch.bool, device=X.device)
    keep[torch.as_tensor(np.asarray(val_rows), device=X.device)] = False
    Xt, Yt = X[keep].to(dtype), Y[keep].to(dtype)
    wt = None if w is None else _col(w[keep].to(dtype))
    nnz = (torch.count_nonzero(wt).to(dtype) if wt is not None
           else torch.tensor(float(Xt.shape[0]), dtype=dtype,
                             device=X.device))
    resolution = float(np.finfo(np.dtype(cfg["dtype"])).resolution * 10)
    ddof = cfg["ddof"]

    def prep(a, center, scale):
        mean = std = None
        if center or scale:
            mean = _mean(a, wt)
        if center:
            a = a - mean
        if scale:
            std = _std(a, 0.0 if center else mean, wt, nnz, ddof, resolution)
            a = a / std
        return a, mean, std

    Xp, X_mean, X_std = prep(Xt, cfg["center_X"], cfg["scale_X"])
    Yp, Y_mean, Y_std = prep(Yt, cfg["center_Y"], cfg["scale_Y"])
    XtW = Xp.T if wt is None else Xp.T * wt.T
    if rows is not None:
        XtW = XtW[torch.as_tensor(np.asarray(rows), device=X.device)]
    f64 = (lambda t: None if t is None else t.to(torch.float64))
    return (f64(XtW @ Xp), f64(XtW @ Yp),
            tuple(f64(s) for s in (X_mean, X_std, Y_mean, Y_std)))
