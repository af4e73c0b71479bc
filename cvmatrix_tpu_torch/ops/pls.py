"""IKPLS Algorithm #2 on each fold of a chunk: plain PyTorch twin, CUDA kernel
wrapper, dispatch.

The port's own kernel: the JAX package fits no per-fold model, so no TPU
kernel stands behind it. For each fold, from its training ``XTX`` (K, K)
and ``XTY`` (K, M) alone, Improved Kernel PLS Algorithm #2 (Dayal &
MacGregor, J. Chemometrics 11:73-85, 1997, as the ``ikpls`` package runs
it) takes ``A`` components in turn::

    w   = XTY q / ||XTY q||, q the dominant eigenvector of XTY^T XTY
    r   = w - sum_{j<a} (p_j . w) r_j
    t   = r^T XTX                      tt = t . r
    p   = t / tt                       q_a = XTY^T r / tt
    XTY = XTY - (p q_a^T) tt

and the fold's validation rows are predicted with 1..A components as the
components come, ``yhat_a = yhat_{a-1} + (x~ . r_a) q_a^T`` with ``x~ =
(x - X_mean) / X_std``, then ``yhat_a * Y_std + Y_mean`` (a flag that is off
drops its term). The result is each fold's weighted PRESS, (F, A, M): the
sum over the validation rows of weight times mask times the squared
residual, for each component count and response.

The M x M eigenproblem is solved by cyclic Jacobi in round-robin order
(:func:`jacobi_dominant`): each round rotates up to M/2 disjoint pairs at
once, until the off-diagonal's Frobenius norm is at most float64's epsilon
times the matrix's (or 30 sweeps). The kernel and the twin run the same
rotations; for M = 1 the vector is 1 and ``w = XTY / ||XTY||``.

Kernel: ``csrc/pls.cu`` (``cvm_ikpls2_f64``), float64, one block a fold,
one launch a chunk. :func:`ikpls2` dispatches as the other wrappers of the
port do: ``impl="auto"`` launches the kernel for CUDA tensors and runs
:func:`ikpls2_reference` for CPU tensors; ``"cuda"`` always launches (and
raises for CPU operands); ``"torch"`` always runs the twin. There is no
float32 kernel: float32 CUDA operands raise under ``"auto"`` and
``"cuda"``, and run the twin only under ``"torch"``. The kernel's library
is built and loaded at its first launch only.

One-row (LOOCV) folds need no formed matrix: :func:`ikpls2_operator` reads
the fitted ``XTX`` and ``XTY``, the fitted rows and the fit's sums, and the
folds' row indices, and applies each fold's training ``XTX`` as the fitted
total plus the fold's rank-one corrections, ``XTX_f r = r1 (.) (XTX (r1
(.) r)) - u (v . r) - p (q . r)`` (the LOOCV kernel's vectors,
``ops/loocv.loocv_reference``), with the fold's statistics from the fit's
sums less its row. Kernel: ``cvm_ikpls2_op_f64`` (``csrc/pls.cu``),
float64, M at most :data:`MAX_M`, K at most :data:`MAX_OP_K`, any A: a
cluster of two blocks holds eight folds and multiplies the shared total by
their eight ``r1 (.) r`` on the FP64 tensor cores each component; twin
:func:`ikpls2_operator_reference`, dispatched as :func:`ikpls2`.

Formed fold matrices wider than :data:`MAX_K` take :func:`ikpls2_wide`,
to which :func:`ikpls2` sends them: the same components and scores, with
the whole card on a chunk of folds rather than one block a fold. Each
component's product ``r^T XTX_f`` is split by rows over many blocks, each
streaming its rows once with the validation rows' scores beside them, and
one fused step a component (a cluster of blocks a fold) sums the splits
and does the vector work: ``tt``, ``p``, ``q_a``, the deflation, the
PRESS, and the next component's ``w`` and Gram-Schmidt ``r`` (Jacobi as
:func:`ikpls2` for M > 1). Kernels: ``csrc/pls.cu``
(``cvm_ikpls2_wide_f64``: 2 A + 2 launches a chunk, every one named
``ikpls2_wide_*``), float64, M at most :data:`MAX_M`, any K; twin
:func:`ikpls2_reference`, dispatched as :func:`ikpls2`. It runs in a span
``cvmatrix_tpu_torch.ops.pls.ikpls2_wide`` (``utils/profiling.py``).

Folds of any L wider than :data:`MAX_K` need no formed matrix either:
:func:`ikpls2_wide_op` reads the fitted totals in place, the fitted rows,
the fit's sums and each fold's rows (and mask), and applies each fold's
training ``XTX`` as the total less the fold's rank-L validation term. With
X centred it centres on the fitted mean ``m0 = sum_X / sum_w``, so that no
product carries the large mean term::

    XTX_f = D^-1 (C - sum_l c_l d_l d_l^T - delta delta^T / sw) D^-1
    C = XTX - sum_w m0 m0^T,   d_l = x_l - m0,   delta = sum_l c_l d_l

(``c_l`` the row's weight times its mask, ``sw`` the training weight sum,
``D`` the training std; uncentred, ``m0`` and ``delta`` are 0), the same
matrix as the formed route's ``XTX - sum_l c_l x_l x_l^T - sw mu mu^T``
scaled, with the training mean ``mu = m0 - delta / sw``. Each component's
``t = XTX_f r`` is ``r1 (.) (C y - sum_l c_l u_l d_l - u_d delta / sw)``
with ``y = r1 (.) r``, ``u_l = d_l . y`` and ``u_d = delta . y``, and the
rows' scores are ``u_l + u_d / sw``. Kernels: ``csrc/pls.cu``
(``cvm_ikpls2_wide_op_f64``: 3 A + 2 launches a chunk, every one named
``ikpls2_wide_*``): a prep (the folds' statistics from the fit's sums less
their rows, each fold's ``XTY`` and ``delta``), then a component's product
(``C y`` of every fold of the chunk from one pass over the upper triangle
of the total, and the scores ``u``), its correction and the wide route's
step. Float64, M at most :data:`MAX_M`, any K, L and A; twin
:func:`ikpls2_wide_op_reference` (which reads the whole total), dispatched
as :func:`ikpls2`. It runs in a span
``cvmatrix_tpu_torch.ops.pls.ikpls2_wide_op``.

Counters: :func:`launch_counts` (kernel launches, ``ikpls2``, ``ikpls2_op``,
``ikpls2_wide`` and ``ikpls2_wide_op``) and :func:`fold_components` (F x A
of every solve, kernel or twin, by route).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..utils.profiling import PLS_WIDE, PLS_WIDE_OP, spanned
from .fold_downdate import _fn, _run, _use_kernel
from .loocv import _ptr
from .loocv import side_mean_std as _side_mean_std
from .precision import highest_precision

__all__ = ["MAX_K", "MAX_M", "MAX_OP_K", "MAX_SWEEPS", "fold_components",
           "ikpls2", "ikpls2_operator", "ikpls2_operator_reference",
           "ikpls2_reference", "ikpls2_wide", "ikpls2_wide_op",
           "ikpls2_wide_op_reference", "jacobi_dominant",
           "max_active_clusters", "round_robin_pairs", "launch_counts",
           "reset_launch_counts"]

# Widest response the kernels take (one warp's lanes over the responses)
# and the widest fold product of ikpls2 (its three K-vectors in shared
# memory); a wider one takes ikpls2_wide.
MAX_M = 32
MAX_K = 8192
# Rows of a split of ikpls2_wide's product (kWideRows in csrc/pls.cu), and
# rows and columns of a tile of ikpls2_wide_op's (kWopStrip, kWopTile).
_WIDE_ROWS = 256
_WOP_STRIP = 256
_WOP_TILE = 512
# Widest K of the operator kernel: a block keeps its cluster's eight
# (r1 (.) r) vectors and four folds' vectors and M x M matrices in shared
# memory, 219 KB at K=768, M=32 (see csrc/pls.cu).
MAX_OP_K = 768
# Jacobi sweeps at most; one sweep rotates every pair once.
MAX_SWEEPS = 30

_FLAG_BITS = {"center_X": 1, "center_Y": 2, "scale_X": 4, "scale_Y": 8}


def round_robin_pairs(m: int):
    """The rounds of one Jacobi sweep over ``m`` indices: a list of rounds,
    each a list of disjoint ``(p, q)`` pairs with ``p < q < m``. The
    tournament order (index 0 fixed, the others rotated) of the kernel:
    in round ``r``, position ``j > 0`` holds ``1 + (j - 1 + r) % (mp -
    1)``, ``mp`` = m rounded up to even, and pair ``i`` is positions ``i``
    and ``mp - 1 - i``; a pair that holds the dummy index ``m`` (odd m) is
    left out."""
    mp = m + (m % 2)
    rounds = []
    for r in range(mp - 1):
        def pos(j):
            return 0 if j == 0 else 1 + (j - 1 + r) % (mp - 1)
        pairs = []
        for i in range(mp // 2):
            a, b = pos(i), pos(mp - 1 - i)
            p, q = min(a, b), max(a, b)
            if q < m:
                pairs.append((p, q))
        rounds.append(pairs)
    return rounds


def jacobi_dominant(S: torch.Tensor, max_sweeps: int = MAX_SWEEPS,
                    basis: Optional[torch.Tensor] = None):
    """The eigenvector of the largest eigenvalue of each symmetric (F, M, M)
    ``S`` -> (F, M), by the kernels' cyclic Jacobi.

    With ``basis``, an (F, M, M) orthogonal matrix ``V0`` (the operator
    kernel's warm start: the last component's eigenvectors), the sweeps
    start from ``V0^T S V0`` with ``V = V0``, and the result is ``(vector,
    V)``, ``V`` the eigenvectors found, for the next warm start.

    Each rotation of pair (p, q): ``theta = (S_qq - S_pp) / (2 S_pq)``,
    ``t = sign(theta) / (|theta| + sqrt(theta^2 + 1))`` (0 where ``S_pq``
    is 0), ``c = 1 / sqrt(t^2 + 1)``, ``s = t c``; the round's columns,
    then its rows, then the eigenvector columns are rotated, and the
    pair's 2 x 2 block is set to ``(S_pp - t S_pq, 0; 0, S_qq + t
    S_pq)``. A fold stops once the off-diagonal part's squared Frobenius
    norm is at most eps^2 times the whole matrix's at the start; the
    vector is the column of the largest diagonal entry (the first of equal
    ones)."""
    f_folds, m, _ = S.shape
    if basis is None:
        S = S.clone()
        V = torch.eye(m, dtype=S.dtype, device=S.device).expand(
            f_folds, m, m).clone()
    else:
        S = (basis.mT @ S) @ basis
        V = basis.clone()
    eps = torch.finfo(S.dtype).eps
    norm2 = (S * S).sum(dim=(1, 2))
    offdiag = ~torch.eye(m, dtype=torch.bool, device=S.device)
    rounds = [rd for rd in round_robin_pairs(m) if rd]
    for _ in range(max_sweeps if rounds else 0):
        off2 = (S * S * offdiag).sum(dim=(1, 2))
        todo = ~(off2 <= eps * eps * norm2)
        if not bool(todo.any()):
            break
        S0, V0 = S.clone(), V.clone()
        for pairs in rounds:
            P = torch.tensor([p for p, _ in pairs], device=S.device)
            Q = torch.tensor([q for _, q in pairs], device=S.device)
            app, aqq, apq = S[:, P, P], S[:, Q, Q], S[:, P, Q]
            zero = apq == 0
            theta = (aqq - app) / (2.0 * torch.where(zero, 1.0, apq))
            t = torch.copysign(torch.ones_like(theta), theta) / (
                theta.abs() + torch.sqrt(theta * theta + 1.0))
            t = torch.where(zero, 0.0, t)
            c = 1.0 / torch.sqrt(t * t + 1.0)
            s = t * c
            cc, sc = c[:, None, :], s[:, None, :]
            sp, sq = S[:, :, P], S[:, :, Q]
            S[:, :, P], S[:, :, Q] = cc * sp - sc * sq, sc * sp + cc * sq
            cr, sr = c[:, :, None], s[:, :, None]
            sp, sq = S[:, P, :], S[:, Q, :]
            S[:, P, :], S[:, Q, :] = cr * sp - sr * sq, sr * sp + cr * sq
            vp, vq = V[:, :, P], V[:, :, Q]
            V[:, :, P], V[:, :, Q] = cc * vp - sc * vq, sc * vp + cc * vq
            S[:, P, P] = app - t * apq
            S[:, Q, Q] = aqq + t * apq
            S[:, P, Q] = 0.0
            S[:, Q, P] = 0.0
        keep = ~todo[:, None, None]
        S = torch.where(keep, S0, S)
        V = torch.where(keep, V0, V)
    top = torch.diagonal(S, dim1=1, dim2=2).argmax(dim=1)
    vec = V[torch.arange(f_folds, device=S.device), :, top]
    return vec if basis is None else (vec, V)


@highest_precision()
def ikpls2_reference(xtx, xty, X_val, Y_val, w_val, mask, stats, *,
                     n_components: int, center_X: bool, center_Y: bool,
                     scale_X: bool, scale_Y: bool) -> torch.Tensor:
    """Plain-torch twin of the kernel -> (F, A, M) weighted PRESS, in the
    operands' dtype.

    ``xtx`` (F, K, K) and ``xty`` (F, K, M) are the folds' training
    matrices (views of one (F, K, K + M) output are fine), ``X_val`` (F, L,
    K) and ``Y_val`` (F, L, M) the validation rows, ``w_val`` and ``mask``
    (F, L) or ``None``, ``stats`` the folds' ``(X_mean, X_std, Y_mean,
    Y_std)``, each (F, 1, W) or ``None``; a statistic is read only where
    its flag is on."""
    X_mean, X_std, Y_mean, Y_std = stats
    f_folds, k, m = xty.shape
    A = n_components
    G = xty.clone()
    xs = X_val
    if center_X:
        xs = xs - X_mean
    if scale_X:
        xs = xs / X_std
    wm = None
    for t in (w_val, mask):
        if t is not None:
            wm = t if wm is None else wm * t
    Pm = xtx.new_zeros((f_folds, A, k))
    Rm = xtx.new_zeros((f_folds, A, k))
    yhat = Y_val.new_zeros(Y_val.shape)
    press = xtx.new_empty((f_folds, A, m))
    for a in range(A):
        qe = jacobi_dominant(G.mT @ G)
        w = (G @ qe[:, :, None])[:, :, 0]
        w = w / torch.linalg.vector_norm(w, dim=1, keepdim=True)
        r = w
        if a:
            d = (Pm[:, :a] @ w[:, :, None])[:, :, 0]
            for j in range(a):
                r = r - d[:, j:j + 1] * Rm[:, j]
        t = (r[:, None, :] @ xtx)[:, 0]
        tt = (t * r).sum(dim=1)[:, None]
        p = t / tt
        qn = (G.mT @ r[:, :, None])[:, :, 0] / tt
        G = G - (p[:, :, None] * qn[:, None, :]) * tt[:, :, None]
        Pm[:, a], Rm[:, a] = p, r
        z = (xs @ r[:, :, None])[:, :, 0]
        yhat = yhat + z[:, :, None] * qn[:, None, :]
        pred = yhat
        if scale_Y:
            pred = pred * Y_std
        if center_Y:
            pred = pred + Y_mean
        e2 = (Y_val - pred) ** 2
        press[:, a] = (e2 if wm is None else wm[:, :, None] * e2).sum(dim=1)
    return press


def _strided(t: Optional[torch.Tensor], on: bool):
    """``(tensor, stride of the first axis)`` of an operand ((F, R, W) or
    (R, W)) whose rows are contiguous, made so where they are not; ``(None,
    0)`` where off."""
    if t is None or not on:
        return None, 0
    if t.stride(-1) != 1:
        t = t.contiguous()
    return t, t.stride(0)


def ikpls2(xtx, xty, X_val, Y_val, w_val, mask, stats, *, n_components: int,
           center_X: bool, center_Y: bool, scale_X: bool, scale_Y: bool,
           impl: str = "auto") -> torch.Tensor:
    """Every fold's IKPLS #2 solve and score -> (F, A, M) weighted PRESS.

    Operands as :func:`ikpls2_reference`; on the kernel's path every one is
    float64 on one CUDA device, ``xtx``/``xty``/statistics with contiguous
    rows (any fold and row strides), the validation rows contiguous and M
    at most :data:`MAX_M`. K over :data:`MAX_K` is solved by
    :func:`ikpls2_wide` (its kernels, twin, span and counters), whatever
    ``impl``."""
    k = xty.shape[1]
    m = xty.shape[2]
    f_folds = xty.shape[0]
    A = int(n_components)
    if A < 1:
        raise ValueError(f"n_components must be at least 1, got {A}")
    flags = dict(center_X=center_X, center_Y=center_Y, scale_X=scale_X,
                 scale_Y=scale_Y)
    if k > MAX_K:
        return ikpls2_wide(xtx, xty, X_val, Y_val, w_val, mask, stats,
                           n_components=A, impl=impl, **flags)
    device = xty.device
    launch = _use_kernel("ikpls2", impl, device)
    if launch and xty.dtype != torch.float64:
        raise ValueError(f"ikpls2 has no kernel for {xty.dtype}; pass "
                         "impl='torch' to run its plain twin")
    ikpls2.fold_components += f_folds * A
    if not launch:
        return ikpls2_reference(xtx, xty, X_val, Y_val, w_val, mask, stats,
                                n_components=A, **flags)
    if m > MAX_M:
        raise ValueError(f"ikpls2's kernel takes M <= {MAX_M} (M={m}); run "
                         "impl='torch'")
    ops = _formed_operands("ikpls2", xtx, xty, X_val, Y_val, w_val, mask,
                           stats, flags)
    n_l = ops.n_l
    g = torch.empty((f_folds, m, k), dtype=torch.float64, device=device)
    pr = torch.empty((f_folds, 2, A, k), dtype=torch.float64, device=device)
    yhat = torch.empty((f_folds, n_l, m), dtype=torch.float64, device=device)
    press = torch.empty((f_folds, A, m), dtype=torch.float64, device=device)
    fn = _fn("pls", "cvm_ikpls2_f64", 14, 13, (ctypes.c_int,))
    _run("ikpls2", fn, *ops.ptrs, _ptr(g), _ptr(pr), _ptr(yhat),
         _ptr(press), f_folds, k, m, n_l, A, *ops.strides, ops.bits,
         device=device)
    ikpls2.launches += 1
    return press


class _Formed(NamedTuple):
    """A chunk's operands on formed fold matrices, checked for a kernel:
    ``tensors`` xtx, xty, the validation rows, weights and mask and the
    four statistics (``None`` where off; copies where rows were not
    contiguous, kept alive here until the launch), their ``strides``
    (xtx's and xty's fold and row strides, then each statistic's fold
    stride), the flag ``bits`` and ``n_l``, the validation rows a fold."""
    tensors: tuple
    strides: tuple
    bits: int
    n_l: int

    @property
    def ptrs(self) -> tuple:
        return tuple(_ptr(t) for t in self.tensors)


def _formed_operands(name, xtx, xty, X_val, Y_val, w_val, mask, stats,
                     flags) -> _Formed:
    """Check the operands of :func:`ikpls2` or :func:`ikpls2_wide` for
    their kernel: every one float64 on xty's device, the shapes (F, K, K),
    (F, K, M), (F, L, K), (F, L, M) and (F, L)."""
    f_folds, k, m = xty.shape
    device = xty.device
    n_l = X_val.shape[1]
    if (tuple(xtx.shape) != (f_folds, k, k)
            or tuple(X_val.shape) != (f_folds, n_l, k)
            or tuple(Y_val.shape) != (f_folds, n_l, m)):
        raise ValueError(
            f"{name}: xtx {tuple(xtx.shape)}, xty {tuple(xty.shape)}, X_val "
            f"{tuple(X_val.shape)} and Y_val {tuple(Y_val.shape)} do not "
            "match (F, K, K), (F, K, M), (F, L, K), (F, L, M)")
    xtx, xtx_sf = _strided(xtx, True)
    xty, xty_sf = _strided(xty, True)
    X_mean, X_std, Y_mean, Y_std = stats
    mean_x, mean_x_sf = _strided(X_mean, flags["center_X"])
    std_x, std_x_sf = _strided(X_std, flags["scale_X"])
    mean_y, mean_y_sf = _strided(Y_mean, flags["center_Y"])
    std_y, std_y_sf = _strided(Y_std, flags["scale_Y"])
    dense = [t.contiguous() if t is not None else None
             for t in (X_val, Y_val, w_val, mask)]
    for t in [xtx, xty, mean_x, std_x, mean_y, std_y, *dense]:
        if t is not None and (t.device != device
                              or t.dtype != torch.float64):
            raise ValueError(f"{name} operands must all be float64 on "
                             f"{device}.")
    for nm, t, shape in (("w_val", dense[2], (f_folds, n_l)),
                         ("mask", dense[3], (f_folds, n_l))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: {nm} must be {shape}, got "
                             f"{tuple(t.shape)}")
    strides = (xtx_sf, xtx.stride(1), xty_sf, xty.stride(1), mean_x_sf,
               std_x_sf, mean_y_sf, std_y_sf)
    bits = sum(b for nm, b in _FLAG_BITS.items() if flags[nm])
    return _Formed((xtx, xty, *dense, mean_x, std_x, mean_y, std_y), strides,
                   bits, n_l)


@spanned(PLS_WIDE)
def ikpls2_wide(xtx, xty, X_val, Y_val, w_val, mask, stats, *,
                n_components: int, center_X: bool, center_Y: bool,
                scale_X: bool, scale_Y: bool,
                impl: str = "auto") -> torch.Tensor:
    """Every fold's IKPLS #2 solve and score on formed fold matrices of any
    K, the whole card on the chunk -> (F, A, M) weighted PRESS.

    Operands and dispatch as :func:`ikpls2` (twin :func:`ikpls2_reference`);
    on the kernel's path (``cvm_ikpls2_wide_f64``, 2 A + 2 launches) M is
    at most :data:`MAX_M` and the chunk at most 65,535 folds. Scratch of
    about F (K L + (K / 256 + 2 A + M) K) values is allocated a call: the
    validation rows' centred and scaled columns, transposed, and the
    product's split sums."""
    f_folds, k, m = xty.shape
    A = int(n_components)
    if A < 1:
        raise ValueError(f"n_components must be at least 1, got {A}")
    flags = dict(center_X=center_X, center_Y=center_Y, scale_X=scale_X,
                 scale_Y=scale_Y)
    device = xty.device
    launch = _use_kernel("ikpls2_wide", impl, device)
    if launch and xty.dtype != torch.float64:
        raise ValueError(f"ikpls2_wide has no kernel for {xty.dtype}; pass "
                         "impl='torch' to run its plain twin")
    ikpls2_wide.fold_components += f_folds * A
    if not launch:
        return ikpls2_reference(xtx, xty, X_val, Y_val, w_val, mask, stats,
                                n_components=A, **flags)
    if m > MAX_M or f_folds > 65535:
        raise ValueError(
            f"ikpls2_wide's kernel takes M <= {MAX_M} and at most 65,535 "
            f"folds a chunk (M={m}, F={f_folds}); run impl='torch'")
    ops = _formed_operands("ikpls2_wide", xtx, xty, X_val, Y_val, w_val,
                           mask, stats, flags)
    n_l = ops.n_l
    splits = -(-k // _WIDE_ROWS)

    def scratch(*shape):
        return torch.empty(shape, dtype=torch.float64, device=device)
    xst, part = scratch(f_folds, k, n_l), scratch(f_folds, splits, k + n_l)
    g, pr = scratch(f_folds, m, k), scratch(f_folds, 2, A, k)
    yhat, z = scratch(f_folds, n_l, m), scratch(f_folds, n_l)
    press = scratch(f_folds, A, m)
    fn = _fn("pls", "cvm_ikpls2_wide_f64", 17, 13, (ctypes.c_int,))
    _run("ikpls2_wide", fn, *ops.ptrs, *(_ptr(t) for t in (
        xst, part, g, pr, yhat, z, press)), f_folds, k, m, n_l, A,
         *ops.strides, ops.bits, device=device)
    ikpls2_wide.launches += 2 * A + 2
    return press


def _fold_statistics(X, Y, weights, sums, rows, mask=None, *, center_X,
                     center_Y, scale_X, scale_Y, ddof, resolution):
    """The folds ``rows`` (F, L) with ``mask`` (F, L) or ``None``: each
    fold's validation rows and training statistics from the fit's sums less
    theirs, as the LOOCV kernels' vector phase computes them
    (``ops.loocv.side_mean_std``, the scalars of
    ``core/batch._fold_scalar_stream``) -> ``(x, y, c, sw, mX, sX, mY,
    sY)``: (F, L, K), (F, L, M), each row's weight times its mask (F, L),
    (F,), (F, K) twice, (F, M) twice. A mean is 0 where no flag needs it
    and a std 1 where its side is not scaled."""
    sum_X, sum_sq_X, sum_Y, sum_sq_Y, sum_w, nnz = sums
    x, y = X[rows], Y[rows]
    c = (torch.ones(rows.shape, dtype=x.dtype, device=x.device)
         if weights is None else weights[rows, 0])
    if mask is not None:
        c = c * mask
    center = center_X or center_Y
    sw = x.new_zeros((rows.shape[0],))
    scal = x.new_zeros((rows.shape[0], 3))
    if center or scale_X or scale_Y:
        sw = sum_w - c.sum(dim=1)
        nnz_t = sw if weights is None else (
            nnz - (c != 0).sum(dim=1)).to(x.dtype)
        divisor = (nnz_t - ddof) * sw / nnz_t
        scal = torch.stack([sw, 1.0 / sw, 1.0 / divisor], dim=1)

    def side(v, s, sq, need_mean, need_std):
        g = v.new_zeros((2, v.shape[2]))
        if need_mean or need_std:
            g[0] = s[0]
        if need_std:
            g[1] = sq[0]
        cv = c[:, :, None] * v
        return _side_mean_std(cv.sum(dim=1),
                              (cv * v).sum(dim=1) if need_std else None, g,
                              scal, need_mean=need_mean,
                              resolution=resolution)

    mX, sX = side(x, sum_X, sum_sq_X, center or scale_X, scale_X)
    mY, sY = side(y, sum_Y, sum_sq_Y, center or scale_Y, scale_Y)
    return x, y, c, sw, mX, sX, mY, sY


@highest_precision()
def ikpls2_operator_reference(xtx, xty, X, Y, weights, sums, rows, *,
                              n_components: int, center_X: bool,
                              center_Y: bool, scale_X: bool, scale_Y: bool,
                              ddof: int, resolution: float) -> torch.Tensor:
    """Plain-torch twin of the operator kernel -> (F, A, M) weighted PRESS
    of the one-row folds ``rows`` (F,), no fold matrix formed.

    ``xtx`` (K, K) and ``xty`` (K, M) are the fitted totals, ``X`` (N, K),
    ``Y`` (N, M) and ``weights`` (N, 1) or ``None`` the fitted rows, and
    ``sums`` the fit's ``(sum_X, sum_sq_X, sum_Y, sum_sq_Y, sum_w,
    num_nonzero_w)`` (``None`` where no flag needs one). A fold's training
    products are the LOOCV kernel's (``ops.loocv.loocv_reference``): with
    ``r1 = 1 / sX``, ``r2 = 1 / sY``, ``u = xw r1``, ``v = x r1``, ``p = sw
    mX r1`` (0 uncentred) and ``q = mX r1`` (0 unless ``center_X``),
    ``XTX_f = xtx (.) (r1 r1^T) - u v^T - p q^T``, and ``XTY_f`` likewise
    with the Y side. Each component runs as :func:`ikpls2_reference` does,
    except three steps: ``t = XTX_f r = r1 (.) (xtx (r1 (.) r)) - u (v . r)
    - p (q . r)``; ``q_a = S q / (||XTY q|| tt)`` with ``S = XTY^T XTY``
    (``= XTY^T r / tt`` in exact arithmetic: the deflated ``XTY`` is
    orthogonal to every earlier ``r``); and Jacobi warm-started from the
    last component's eigenvectors (:func:`jacobi_dominant` with
    ``basis``), in whose basis the deflated ``S`` differs from a diagonal
    matrix only in one row and column."""
    x, y, c, sw, mX, sX, mY, sY = _fold_statistics(
        X, Y, weights, sums, rows[:, None], center_X=center_X,
        center_Y=center_Y, scale_X=scale_X, scale_Y=scale_Y, ddof=ddof,
        resolution=resolution)
    x, y = x[:, 0], y[:, 0]
    wv = None if weights is None else c[:, 0]
    center = center_X or center_Y
    f_folds, k = x.shape
    m = y.shape[1]
    A = n_components
    r1, r2 = 1.0 / sX, 1.0 / sY
    xw = x if wv is None else x * wv[:, None]
    u, v = xw * r1, x * r1
    mr = mX * r1
    p = sw[:, None] * mr if center else torch.zeros_like(mr)
    q = mr if center_X else torch.zeros_like(mr)
    vy = y * r2
    qy = mY * r2 if center else torch.zeros_like(mY)
    G = (xty * (r1[:, :, None] * r2[:, None, :]) - u[:, :, None]
         * vy[:, None, :] - p[:, :, None] * qy[:, None, :])
    xs = x
    if center_X:
        xs = xs - mX
    if scale_X:
        xs = xs / sX
    Pm = x.new_zeros((f_folds, A, k))
    Rm = x.new_zeros((f_folds, A, k))
    yhat = y.new_zeros(y.shape)
    press = x.new_empty((f_folds, A, m))
    V = torch.eye(m, dtype=x.dtype, device=x.device).expand(
        f_folds, m, m)
    for a in range(A):
        S = G.mT @ G
        qe, V = jacobi_dominant(S, basis=V)
        w = (G @ qe[:, :, None])[:, :, 0]
        nrm = torch.linalg.vector_norm(w, dim=1, keepdim=True)
        w = w / nrm
        r = w
        if a:
            d = (Pm[:, :a] @ w[:, :, None])[:, :, 0]
            for j in range(a):
                r = r - d[:, j:j + 1] * Rm[:, j]
        t = (r1 * ((r1 * r) @ xtx.mT) - u * (v * r).sum(1, keepdim=True)
             - p * (q * r).sum(1, keepdim=True))
        tt = (t * r).sum(dim=1)[:, None]
        pa = t / tt
        qn = (S @ qe[:, :, None])[:, :, 0] / (nrm * tt)
        G = G - (pa[:, :, None] * qn[:, None, :]) * tt[:, :, None]
        Pm[:, a], Rm[:, a] = pa, r
        z = (xs * r).sum(dim=1, keepdim=True)
        yhat = yhat + z * qn
        pred = yhat
        if scale_Y:
            pred = pred * sY
        if center_Y:
            pred = pred + mY
        e2 = (y - pred) ** 2
        press[:, a] = e2 if wv is None else wv[:, None] * e2
    return press


def _press_out(name, out, f_folds, A, m, device):
    """``out`` checked as a contiguous (F, A, M) float64 tensor on
    ``device``, or a new one where ``None``."""
    if out is None:
        return torch.empty((f_folds, A, m), dtype=torch.float64, device=device)
    if (tuple(out.shape) != (f_folds, A, m) or out.dtype != torch.float64
            or out.device != device or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be a contiguous ({f_folds}, {A}, "
                         f"{m}) float64 tensor on {device}")
    return out


def ikpls2_operator(xtx, xty, X, Y, weights, sums, rows, *,
                    n_components: int, center_X: bool, center_Y: bool,
                    scale_X: bool, scale_Y: bool, ddof: int,
                    resolution: float, impl: str = "auto",
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every one-row fold's IKPLS #2 solve and score, no fold matrix
    formed -> (F, A, M) weighted PRESS, written into ``out`` where given
    (as :func:`ikpls2_wide_op` takes it).

    Operands as :func:`ikpls2_operator_reference`; on the kernel's path
    (``cvm_ikpls2_op_f64``) every one is float64 on one CUDA device, with
    ``rows`` int64 in [0, N) (not checked here), M at most :data:`MAX_M`
    and K at most :data:`MAX_OP_K`. Dispatch as :func:`ikpls2`."""
    k, m = xty.shape
    f_folds = rows.shape[0]
    A = int(n_components)
    if A < 1:
        raise ValueError(f"n_components must be at least 1, got {A}")
    flags = dict(center_X=center_X, center_Y=center_Y, scale_X=scale_X,
                 scale_Y=scale_Y)
    device = xty.device
    launch = _use_kernel("ikpls2_op", impl, device)
    if launch and xty.dtype != torch.float64:
        raise ValueError(f"ikpls2_op has no kernel for {xty.dtype}; pass "
                         "impl='torch' to run its plain twin")
    ikpls2_operator.fold_components += f_folds * A
    if not launch:
        press = ikpls2_operator_reference(
            xtx, xty, X, Y, weights, sums, rows, n_components=A, ddof=ddof,
            resolution=resolution, **flags)
        return press if out is None else out.copy_(press)
    if m > MAX_M or k > MAX_OP_K:
        raise ValueError(
            f"ikpls2_op's kernel takes M <= {MAX_M} and K <= {MAX_OP_K} "
            f"(M={m}, K={k}); run impl='torch'")
    n = X.shape[0]
    if (tuple(xtx.shape) != (k, k) or tuple(X.shape) != (n, k)
            or tuple(Y.shape) != (n, m)
            or (weights is not None and tuple(weights.shape) != (n, 1))):
        raise ValueError(
            f"ikpls2_op: xtx {tuple(xtx.shape)}, xty {tuple(xty.shape)}, X "
            f"{tuple(X.shape)}, Y {tuple(Y.shape)} do not match (K, K), (K, "
            "M), (N, K), (N, M), weights (N, 1)")
    xtx, xty, X, Y = (_strided(t, True)[0] for t in (xtx, xty, X, Y))
    sums = [None if s is None else s.reshape(-1) for s in sums]
    nnz = sums[5]
    for t in [xtx, xty, X, Y, weights, *sums[:5]]:
        if t is not None and (t.device != device
                              or t.dtype != torch.float64):
            raise ValueError(f"ikpls2_op operands must all be float64 on "
                             f"{device}.")
    if rows.device != device or rows.dtype != torch.int64 or (
            nnz is not None and (nnz.device != device
                                 or nnz.dtype != torch.int64)):
        raise ValueError(f"ikpls2_op: rows and num_nonzero_w must be int64 "
                         f"on {device}.")
    press = _press_out("ikpls2_op", out, f_folds, A, m, device)
    rows = rows.contiguous()
    g = torch.empty((f_folds, k, m), dtype=torch.float64, device=device)
    pr = torch.empty((f_folds, 2, A, k), dtype=torch.float64, device=device)
    vec = torch.empty((f_folds, 3, k), dtype=torch.float64, device=device)
    aux = torch.empty((f_folds, m * m + A), dtype=torch.float64,
                      device=device)
    fn = _fn("pls", "cvm_ikpls2_op_f64", 17, 11,
             (ctypes.c_double, ctypes.c_int))
    bits = sum(b for nm, b in _FLAG_BITS.items() if flags[nm])
    _run("ikpls2_op", fn, _ptr(xtx), _ptr(xty), _ptr(X), _ptr(Y),
         _ptr(weights), *(_ptr(s) for s in sums), _ptr(rows), _ptr(g),
         _ptr(pr), _ptr(vec), _ptr(aux), _ptr(press), f_folds, n, k, m, A,
         xtx.stride(0), xty.stride(0), X.stride(0), Y.stride(0),
         0 if weights is None else weights.stride(0), int(ddof),
         float(resolution), bits, device=device)
    ikpls2_operator.launches += 1
    return press


@highest_precision()
def ikpls2_wide_op_reference(xtx, xty, X, Y, weights, sums, rows, mask, *,
                             n_components: int, center_X: bool,
                             center_Y: bool, scale_X: bool, scale_Y: bool,
                             ddof: int, resolution: float) -> torch.Tensor:
    """Plain-torch twin of the wide operator kernels -> (F, A, M) weighted
    PRESS of the folds ``rows`` (F, L) int64 with ``mask`` (F, L) or
    ``None``, no fold matrix formed.

    ``xtx``, ``xty``, ``X``, ``Y``, ``weights`` and ``sums`` as
    :func:`ikpls2_operator_reference`. Each fold's statistics are the
    operator's (its rows' sums taken off the fit's) and its ``XTY``
    is formed: ``(xty - sum_l c_l x_l y_l^T - sw mX mY^T) / (sX sY^T)``,
    each term only where its flag is on. Its ``XTX`` is applied as the
    module's doc says: ``t = r1 (.) (C y - sum_l c_l u_l d_l - u_d delta
    / sw)``, C the whole total centred on ``m0``, and the rows' scores are
    ``u + u_d / sw``; every other step runs as :func:`ikpls2_reference`
    does."""
    x, y, c, sw, mX, sX, mY, sY = _fold_statistics(
        X, Y, weights, sums, rows, mask, center_X=center_X,
        center_Y=center_Y, scale_X=scale_X, scale_Y=scale_Y, ddof=ddof,
        resolution=resolution)
    f_folds, n_l, k = x.shape
    m = y.shape[2]
    A = n_components
    cx = c[:, :, None] * x
    G = xty - cx.mT @ y
    if center_X or center_Y:
        G = G - sw[:, None, None] * (mX[:, :, None] * mY[:, None, :])
    if scale_X and scale_Y:
        G = G / (sX[:, :, None] * sY[:, None, :])
    elif scale_X:
        G = G / sX[:, :, None]
    elif scale_Y:
        G = G / sY[:, None, :]
    C, d, delta = xtx, x, None
    if center_X:
        m0 = sums[0].reshape(-1) / sums[4]
        C = xtx - (sums[4] * m0)[:, None] * m0[None, :]
        d = x - m0
        delta = (c[:, :, None] * d).sum(dim=1)
    r1 = 1.0 / sX
    wm = None
    for t in (None if weights is None else weights[rows, 0], mask):
        if t is not None:
            wm = t if wm is None else wm * t
    Pm = x.new_zeros((f_folds, A, k))
    Rm = x.new_zeros((f_folds, A, k))
    yhat = y.new_zeros(y.shape)
    press = x.new_empty((f_folds, A, m))
    for a in range(A):
        qe = jacobi_dominant(G.mT @ G)
        w = (G @ qe[:, :, None])[:, :, 0]
        w = w / torch.linalg.vector_norm(w, dim=1, keepdim=True)
        r = w
        if a:
            dots = (Pm[:, :a] @ w[:, :, None])[:, :, 0]
            for j in range(a):
                r = r - dots[:, j:j + 1] * Rm[:, j]
        yv = r1 * r
        u = (d @ yv[:, :, None])[:, :, 0]
        corr = (d.mT @ (c * u)[:, :, None])[:, :, 0]
        z = u
        if center_X:
            ud = (delta * yv).sum(dim=1, keepdim=True) / sw[:, None]
            corr = corr + ud * delta
            z = u + ud
        t = r1 * (yv @ C - corr)
        tt = (t * r).sum(dim=1)[:, None]
        p = t / tt
        qn = (G.mT @ r[:, :, None])[:, :, 0] / tt
        G = G - (p[:, :, None] * qn[:, None, :]) * tt[:, :, None]
        Pm[:, a], Rm[:, a] = p, r
        yhat = yhat + z[:, :, None] * qn[:, None, :]
        pred = yhat
        if scale_Y:
            pred = pred * sY[:, None, :]
        if center_Y:
            pred = pred + mY[:, None, :]
        e2 = (y - pred) ** 2
        press[:, a] = (e2 if wm is None else wm[:, :, None] * e2).sum(dim=1)
    return press


@spanned(PLS_WIDE_OP)
def ikpls2_wide_op(xtx, xty, X, Y, weights, sums, rows, mask, *,
                   n_components: int, center_X: bool, center_Y: bool,
                   scale_X: bool, scale_Y: bool, ddof: int,
                   resolution: float, impl: str = "auto",
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every fold's IKPLS #2 solve and score, no fold matrix formed, folds
    of any L -> (F, A, M) weighted PRESS, written into ``out`` where given
    (a contiguous (F, A, M) float64 tensor on the operands' device).

    Operands as :func:`ikpls2_wide_op_reference`; on the kernel's path
    (``cvm_ikpls2_wide_op_f64``, 3 A + 2 launches) every one is float64 on
    one CUDA device, ``rows`` int64 in [0, N) (not checked here), M at
    most :data:`MAX_M` and the chunk at most 65,535 folds. Scratch of about
    F (K (K / 256 + 2 A + M + 3) + L (M + 4)) values is allocated a call.
    Dispatch as :func:`ikpls2`."""
    k, m = xty.shape
    f_folds, n_l = rows.shape
    A = int(n_components)
    if A < 1:
        raise ValueError(f"n_components must be at least 1, got {A}")
    flags = dict(center_X=center_X, center_Y=center_Y, scale_X=scale_X,
                 scale_Y=scale_Y)
    device = xty.device
    launch = _use_kernel("ikpls2_wide_op", impl, device)
    if launch and xty.dtype != torch.float64:
        raise ValueError(f"ikpls2_wide_op has no kernel for {xty.dtype}; "
                         "pass impl='torch' to run its plain twin")
    ikpls2_wide_op.fold_components += f_folds * A
    if not launch:
        press = ikpls2_wide_op_reference(
            xtx, xty, X, Y, weights, sums, rows, mask, n_components=A,
            ddof=ddof, resolution=resolution, **flags)
        return press if out is None else out.copy_(press)
    if m > MAX_M or f_folds > 65535:
        raise ValueError(
            f"ikpls2_wide_op's kernel takes M <= {MAX_M} and at most 65,535 "
            f"folds a chunk (M={m}, F={f_folds}); run impl='torch'")
    n = X.shape[0]
    if (tuple(xtx.shape) != (k, k) or tuple(X.shape) != (n, k)
            or tuple(Y.shape) != (n, m)
            or (weights is not None and tuple(weights.shape) != (n, 1))
            or (mask is not None and tuple(mask.shape) != (f_folds, n_l))):
        raise ValueError(
            f"ikpls2_wide_op: xtx {tuple(xtx.shape)}, xty {tuple(xty.shape)}, "
            f"X {tuple(X.shape)}, Y {tuple(Y.shape)} do not match (K, K), "
            "(K, M), (N, K), (N, M), weights (N, 1), mask (F, L)")
    xtx, xty, X, Y = (_strided(t, True)[0] for t in (xtx, xty, X, Y))
    sums = [None if s is None else s.reshape(-1) for s in sums]
    nnz = sums[5]
    mask = None if mask is None else mask.contiguous()
    for t in [xtx, xty, X, Y, weights, mask, *sums[:5]]:
        if t is not None and (t.device != device
                              or t.dtype != torch.float64):
            raise ValueError(f"ikpls2_wide_op operands must all be float64 "
                             f"on {device}.")
    if rows.device != device or rows.dtype != torch.int64 or (
            nnz is not None and (nnz.device != device
                                 or nnz.dtype != torch.int64)):
        raise ValueError(f"ikpls2_wide_op: rows and num_nonzero_w must be "
                         f"int64 on {device}.")
    out = _press_out("ikpls2_wide_op", out, f_folds, A, m, device)
    rows = rows.contiguous()
    splits, tiles = -(-k // _WOP_STRIP), -(-k // _WOP_TILE)

    def scratch(*shape):
        return torch.empty(shape, dtype=torch.float64, device=device)
    vec, ystat, scal = scratch(f_folds, 2, k), scratch(f_folds, 2, m), \
        scratch(f_folds)
    g, yv = scratch(f_folds, m, k), scratch(f_folds, n_l, m)
    wv = None if weights is None else scratch(f_folds, n_l)
    colpart, rowpart = scratch(f_folds, splits, k), scratch(f_folds, tiles, k)
    u, part = scratch(f_folds, n_l + 1), scratch(f_folds, k + n_l)
    pr, yhat, z = (scratch(f_folds, 2, A, k), scratch(f_folds, n_l, m),
                   scratch(f_folds, n_l))
    fn = _fn("pls", "cvm_ikpls2_wide_op_f64", 27, 11,
             (ctypes.c_double, ctypes.c_int))
    bits = sum(b for nm, b in _FLAG_BITS.items() if flags[nm])
    _run("ikpls2_wide_op", fn, *(_ptr(t) for t in (
        xtx, xty, X, Y, weights, *sums, rows, mask, vec, ystat, scal, g, yv,
        wv, colpart, rowpart, u, part, pr, yhat, z, out)),
         f_folds, k, m, n_l, A, xtx.stride(0), xty.stride(0), X.stride(0),
         Y.stride(0), 0 if weights is None else weights.stride(0), int(ddof),
         float(resolution), bits, device=device)
    ikpls2_wide_op.launches += 3 * A + 2
    return out


def max_active_clusters(k: int, m: int, device=None) -> int:
    """How many clusters of the operator kernel (eight folds each) the card
    holds at once for K = ``k`` and M = ``m``: a chunk of more folds than
    eight times that runs in more than one wave. Builds the kernel's
    library; raises on a CUDA error."""
    device = torch.device("cuda") if device is None else torch.device(device)
    from . import _build

    fn = _build.load_library("pls").cvm_ikpls2_op_clusters
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int64, ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    err = ctypes.c_int(0)
    n = fn(int(k), int(m), ctypes.byref(err), device.index or 0)
    if err.value:
        raise RuntimeError(f"ikpls2_op occupancy: cudaError {err.value}")
    return n


_ROUTES = {"operator": ikpls2_operator, "matrices": ikpls2,
           "wide": ikpls2_wide, "wide_op": ikpls2_wide_op}


def reset_launch_counts() -> None:
    for fn in _ROUTES.values():
        fn.launches = 0
        fn.fold_components = 0


def launch_counts() -> dict:
    """``{"ikpls2": launches, "ikpls2_op": launches, "ikpls2_wide":
    launches, "ikpls2_wide_op": launches}`` since the last
    :func:`reset_launch_counts`: the kernel on formed fold matrices, the
    operator kernel, the wide route's kernels on formed matrices (2 A + 2 a
    chunk) and without them (3 A + 2 a chunk)."""
    return {"ikpls2": ikpls2.launches, "ikpls2_op": ikpls2_operator.launches,
            "ikpls2_wide": ikpls2_wide.launches,
            "ikpls2_wide_op": ikpls2_wide_op.launches}


def fold_components(route: Optional[str] = None) -> int:
    """The fold-components solved since the last :func:`reset_launch_counts`,
    F x A a solve, the twins' included: of the route ``"operator"``
    (:func:`ikpls2_operator`), ``"matrices"`` (:func:`ikpls2`, on formed
    fold matrices), ``"wide"`` (:func:`ikpls2_wide`, on formed fold
    matrices wider than :data:`MAX_K`) or ``"wide_op"``
    (:func:`ikpls2_wide_op`, none formed), or of every route where
    ``route`` is ``None``."""
    if route is None:
        return sum(fn.fold_components for fn in _ROUTES.values())
    if route not in _ROUTES:
        raise ValueError(f"Unknown route: {route!r} "
                         "(operator|matrices|wide|wide_op).")
    return _ROUTES[route].fold_components


reset_launch_counts()
