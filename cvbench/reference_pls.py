"""The plain reference that decides ``correct`` in the PLS cells: a fold's
weighted PRESS for 1..A components of Improved Kernel PLS Algorithm #2,
fitted on the fold's explicitly weighted, centred and scaled training rows.

A frozen copy of ``tests/pls_reference.py`` (``training_products``,
``ikpls2_coefficients``, ``fold_press``), taking the harness's inputs and a
configuration's dict, so that it runs on the card. It imports nothing of the
program and takes nothing the program made. The training matrices follow
the definitions of ``tests/oracle.py`` (the training rows gathered,
weighted mean, weighted std with divisor ``(nnz - ddof) * sum_w / nnz``
about the mean, stds at or under the resolution replaced by 1, centred and
scaled where the flags say, ``XTX = Xp^T W Xp``, ``XTY = Xp^T W Yp``); the
fit is Dayal & MacGregor's Algorithm 2 (J. Chemometrics 11:73-85, 1997) as
``ikpls`` runs it, with ``eigh`` and the largest eigenvalue's vector; a
validation row ``x`` is predicted as ``((x - X_mean) / X_std) B_a * Y_std +
Y_mean``, a term only where its flag is on, and ``PRESS[a - 1, m]`` is the
sum over the fold's validation rows of the row's weight times the squared
residual. Departures from ``ikpls``: no early stop at a zero ``w`` (NaN
follows instead of zero coefficients). ``dtype`` is the precision it
computes in (float64 is the reference; a lower one is the control); the
result comes back in float64. TF32 is off.
"""

from __future__ import annotations

import numpy as np
import torch


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _training_products(X, Y, w, keep, cfg: dict, resolution: float):
    """``(XTX, XTY, (X_mean, X_std, Y_mean, Y_std))`` of the rows ``keep``,
    each statistic ``None`` where its flag is off."""
    Xt, Yt = X[keep], Y[keep]
    wt = None if w is None else w[keep].reshape(-1, 1)
    n = Xt.shape[0]
    sum_w = (torch.tensor(float(n), dtype=X.dtype, device=X.device)
             if wt is None else wt.sum())
    nnz = (torch.tensor(float(n), dtype=X.dtype, device=X.device)
           if wt is None else torch.count_nonzero(wt).to(X.dtype))
    ww = 1.0 if wt is None else wt
    ddof = cfg["ddof"]

    def prep(a, center, scale):
        mean = (ww * a).sum(0, keepdim=True) / sum_w
        divisor = (nnz - ddof) * sum_w / nnz
        std = ((ww * (a - mean) ** 2).sum(0, keepdim=True) / divisor).sqrt()
        std = torch.where(std.abs() <= resolution, torch.ones_like(std), std)
        if center:
            a = a - mean
        if scale:
            a = a / std
        return a, (mean if center else None), (std if scale else None)

    Xp, X_mean, X_std = prep(Xt, cfg["center_X"], cfg["scale_X"])
    Yp, Y_mean, Y_std = prep(Yt, cfg["center_Y"], cfg["scale_Y"])
    XtW = Xp.T if wt is None else Xp.T * wt.T
    return XtW @ Xp, XtW @ Yp, (X_mean, X_std, Y_mean, Y_std)


def _ikpls2_coefficients(XTX, XTY, n_components: int) -> torch.Tensor:
    """(A, K, M) coefficients of IKPLS Algorithm #2 on one fold's training
    ``XTX`` and ``XTY``."""
    K, M = XTY.shape
    XTY = XTY.clone()
    P = XTX.new_zeros((K, n_components))
    R = XTX.new_zeros((K, n_components))
    B = XTX.new_zeros((n_components, K, M))
    for i in range(n_components):
        if M == 1:
            w = XTY / torch.linalg.vector_norm(XTY)
        elif M < K:
            _, vecs = torch.linalg.eigh(XTY.T @ XTY)
            w = XTY @ vecs[:, -1:]
            w = w / torch.linalg.vector_norm(w)
        else:
            _, vecs = torch.linalg.eigh(XTY @ XTY.T)
            w = vecs[:, -1:]
        r = w.clone()
        for j in range(i):
            r = r - (P[:, j:j + 1].T @ w) * R[:, j:j + 1]
        rXTX = r.T @ XTX
        tTt = rXTX @ r
        p = rXTX.T / tTt
        q = (r.T @ XTY).T / tTt
        XTY = XTY - (p @ q.T) * tTt
        P[:, i:i + 1], R[:, i:i + 1] = p, r
        B[i] = (B[i - 1] if i else 0.0) + r @ q.T
    return B


def fold_press(X, Y, w, val_rows, cfg: dict, *,
               dtype=torch.float64) -> torch.Tensor:
    """(A, M) weighted PRESS of the fold whose validation rows are
    ``val_rows`` (every other row trains), ``A = cfg["n_components"]``,
    computed in ``dtype`` on the inputs' device, returned in float64."""
    _no_tf32()
    X, Y = X.to(dtype), Y.to(dtype)
    w = None if w is None else w.reshape(-1).to(dtype)
    keep = torch.ones(X.shape[0], dtype=torch.bool, device=X.device)
    vi = torch.as_tensor(np.asarray(val_rows), device=X.device)
    keep[vi] = False
    resolution = float(np.finfo(np.dtype(cfg["dtype"])).resolution * 10)
    XTX, XTY, (X_mean, X_std, Y_mean, Y_std) = _training_products(
        X, Y, w, keep, cfg, resolution)
    B = _ikpls2_coefficients(XTX, XTY, cfg["n_components"])
    Xv, Yv = X[vi], Y[vi]
    if cfg["center_X"]:
        Xv = Xv - X_mean
    if cfg["scale_X"]:
        Xv = Xv / X_std
    pred = Xv @ B                                        # (A, L, M)
    if cfg["scale_Y"]:
        pred = pred * Y_std
    if cfg["center_Y"]:
        pred = pred + Y_mean
    e2 = (Yv - pred) ** 2
    if w is not None:
        e2 = e2 * w[vi].reshape(1, -1, 1)
    return e2.sum(dim=1).to(torch.float64)
