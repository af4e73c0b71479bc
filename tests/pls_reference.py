"""Plain reference of PLS cross-validation: Improved Kernel PLS Algorithm #2
fitted fold by fold on the fold's explicitly weighted, centred and scaled
training rows, and the fold's validation rows scored by their weighted PRESS.

Plain torch, float64 unless asked otherwise, TF32 off; it imports no JAX and
nothing of ``cvmatrix_tpu_torch``. The training matrices and statistics are
formed from the definitions, as ``tests/oracle.py`` forms them: the fold's
training rows (every row but its validation rows) gathered, the weighted
mean, the weighted std with divisor ``(nnz - ddof) * sum_w / nnz`` taken
about the mean, stds at or under the resolution replaced by 1, the rows
centred and scaled where the flags say, then ``XTX = Xp^T W Xp`` and ``XTY
= Xp^T W Yp``.

The fit is Dayal & MacGregor's Algorithm 2 (J. Chemometrics 11:73-85,
1997) in the textbook loop, as ``ikpls`` (Engstrøm et al., JOSS 2024;
``ikpls/numpy_ikpls.py``) runs it: for a = 1..A, ``w`` the normalised
``XTY`` (M = 1), or ``XTY q`` normalised with ``q`` the eigenvector of the
largest eigenvalue of ``XTY^T XTY`` from ``eigh`` (M < K), or that of
``XTY XTY^T`` (K <= M); ``r = w - sum_j (p_j^T w) r_j``; ``tTt = r^T XTX
r``; ``p = XTX^T r / tTt``; ``q = XTY^T r / tTt``; ``XTY -= p q^T tTt``;
``B_a = B_{a-1} + r q^T``. A validation row ``x`` is predicted as
``((x - X_mean) / X_std) B_a * Y_std + Y_mean``, a term only where its flag
is on, and ``PRESS[a - 1, m] = sum_rows w (y_m - yhat_m)^2`` (w = 1
unweighted).

Departures from ``ikpls``: no early stop when ``w``'s norm is 0 (``ikpls``
warns and leaves the remaining coefficients at 0; here they read NaN), and
no ``P``, ``Q``, ``W``, ``T`` kept beyond what ``B`` needs. PRESS is the
scoring that this repository's PLS cross-validation returns (``ikpls``
takes the metric from its caller).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["training_products", "ikpls2_coefficients", "fold_press",
           "nipals_coefficients"]


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def training_products(X, Y, w, train, *, center_X: bool, center_Y: bool,
                      scale_X: bool, scale_Y: bool, ddof: int,
                      resolution: float):
    """``(XTX, XTY, (X_mean, X_std, Y_mean, Y_std), Xp, Yp, w_train)`` of
    the training rows ``train``: each statistic (1, W), ``None`` where its
    flag is off; ``Xp``, ``Yp`` the centred and scaled training rows and
    ``w_train`` their (n, 1) weights (``None`` unweighted)."""
    Xt, Yt = X[train], Y[train]
    wt = None if w is None else w[train].reshape(-1, 1)
    n = Xt.shape[0]
    sum_w = (torch.tensor(float(n), dtype=X.dtype, device=X.device)
             if wt is None else wt.sum())
    nnz = (torch.tensor(float(n), dtype=X.dtype, device=X.device)
           if wt is None else torch.count_nonzero(wt).to(X.dtype))
    ww = 1.0 if wt is None else wt

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

    Xp, X_mean, X_std = prep(Xt, center_X, scale_X)
    Yp, Y_mean, Y_std = prep(Yt, center_Y, scale_Y)
    XtW = Xp.T if wt is None else Xp.T * wt.T
    return (XtW @ Xp, XtW @ Yp, (X_mean, X_std, Y_mean, Y_std), Xp, Yp,
            wt)


def ikpls2_coefficients(XTX, XTY, n_components: int) -> torch.Tensor:
    """(A, K, M) regression coefficients ``B_a`` of IKPLS Algorithm #2 on
    one fold's training ``XTX`` (K, K) and ``XTY`` (K, M)."""
    _no_tf32()
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


def fold_press(X, Y, w, val, *, n_components: int, center_X: bool,
               center_Y: bool, scale_X: bool, scale_Y: bool, ddof: int,
               resolution: Optional[float] = None,
               dtype=torch.float64) -> torch.Tensor:
    """(A, M) weighted PRESS of the fold whose validation rows are ``val``
    (indices into the N rows; every other row trains), computed in
    ``dtype``; ``X`` (N, K), ``Y`` (N, M), ``w`` (N,) or ``None``.
    ``resolution`` defaults to float64's ``resolution * 10``."""
    _no_tf32()
    if resolution is None:
        resolution = float(np.finfo(np.float64).resolution * 10)
    X, Y = X.to(dtype), Y.to(dtype)
    w = None if w is None else w.reshape(-1).to(dtype)
    n = X.shape[0]
    keep = torch.ones(n, dtype=torch.bool, device=X.device)
    keep[torch.as_tensor(np.asarray(val), device=X.device)] = False
    flags = dict(center_X=center_X, center_Y=center_Y, scale_X=scale_X,
                 scale_Y=scale_Y)
    XTX, XTY, (X_mean, X_std, Y_mean, Y_std), *_ = training_products(
        X, Y, w, keep, ddof=ddof, resolution=resolution, **flags)
    B = ikpls2_coefficients(XTX, XTY, n_components)
    vi = torch.as_tensor(np.asarray(val), device=X.device)
    Xv, Yv = X[vi], Y[vi]
    if center_X:
        Xv = Xv - X_mean
    if scale_X:
        Xv = Xv / X_std
    pred = Xv @ B                                        # (A, L, M)
    if scale_Y:
        pred = pred * Y_std
    if center_Y:
        pred = pred + Y_mean
    e2 = (Yv - pred) ** 2
    if w is not None:
        e2 = e2 * w[vi].reshape(1, -1, 1)
    return e2.sum(dim=1).to(torch.float64)


def nipals_coefficients(Xw, Yw, n_components: int, *, tol: float = 1e-15,
                        max_iter: int = 100_000) -> Tuple[torch.Tensor, int]:
    """``(B, worst iterations)``: (A, K, M) coefficients of NIPALS PLS2 on
    the rows ``Xw`` (n, K), ``Yw`` (n, M), already weighted (each row times
    the square root of its weight), centred and scaled. An independent
    algorithm for :func:`ikpls2_coefficients`: ``w = E^T u / ||E^T u||``,
    ``t = E w``, ``q = F^T t / t^T t``, ``u = F q / q^T q`` until ``t``
    stops moving (relative ``tol``), then ``p = E^T t / t^T t``, ``E -= t
    p^T``, ``F -= t q^T``, and ``B_a = W_a (P_a^T W_a)^-1 Q_a^T``."""
    E, Fm = Xw.clone(), Yw.clone()
    Ws, Ps, Qs, B = [], [], [], []
    worst = 0
    for _ in range(n_components):
        u = Fm[:, int(torch.argmax((Fm * Fm).sum(0)))].reshape(-1, 1)
        t_old = None
        for it in range(max_iter):
            w = E.T @ u
            w = w / torch.linalg.vector_norm(w)
            t = E @ w
            q = Fm.T @ t / (t.T @ t)
            u = Fm @ q / (q.T @ q)
            if t_old is not None and float(torch.linalg.vector_norm(
                    t - t_old)) <= tol * float(torch.linalg.vector_norm(t)):
                break
            t_old = t
        worst = max(worst, it + 1)
        p = E.T @ t / (t.T @ t)
        E = E - t @ p.T
        Fm = Fm - t @ q.T
        Ws.append(w)
        Ps.append(p)
        Qs.append(q)
        W, P, Q = (torch.cat(v, dim=1) for v in (Ws, Ps, Qs))
        B.append(W @ torch.linalg.solve(P.T @ W, Q.T))
    return torch.stack(B), worst
