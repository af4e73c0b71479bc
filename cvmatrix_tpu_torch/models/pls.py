"""PLS cross-validation on the port: IKPLS Algorithm #2 fitted on every fold's
training matrices, each fold scored by the weighted PRESS of its validation
rows.

The port's own capability; the JAX package fits no per-fold model. It is
the fast cross-validation that the ``ikpls`` package (Engstrøm et al., JOSS
9(99) 6533, 2024) builds on cvmatrix: each fold's PLS model is fitted by
Improved Kernel PLS Algorithm #2 (Dayal & MacGregor, J. Chemometrics
11:73-85, 1997) from that fold's training ``XTX`` and ``XTY`` alone, its
validation rows are predicted with 1..A components, and each component
count is scored, so that the user can choose A.

:func:`cross_validate_pls` takes one of four routes, by what the input
shows (:func:`operator_route` names the first two). Under ``impl="auto"``
or ``"cuda"`` a float64 state forms no fold matrix on two of them: one loop
of chunks of ``batch_size`` folds, the rows and mask copied to the state's
device once a call, each chunk's PRESS written into its folds' rows of one
output. A leave-one-out batch (one unmasked row a fold) with K at most
``ops.pls.MAX_OP_K`` (``"operator"``) runs one :func:`solve_operator` a
chunk, i.e. one ``ops.pls.ikpls2_operator`` (the kernel
``cvm_ikpls2_op_f64`` on the card, its twin on the CPU), which applies each
fold's training ``XTX`` as the fitted total plus the fold's rank-one
corrections. A K-fold or masked bucket with K over ``ops.pls.MAX_OP_K``,
and a leave-one-out bucket with K over ``ops.pls.MAX_K`` (``"wide_op"``),
runs one :func:`solve_wide_operator` a chunk, i.e. one
``ops.pls.ikpls2_wide_op`` (the kernels ``cvm_ikpls2_wide_op_f64``, the
whole card on the chunk, or their twin on the CPU), which applies each
fold's training ``XTX`` as the fitted total less the fold's rank-L
validation term. Every other bucket (K-fold and masked up to
``ops.pls.MAX_OP_K``, leave-one-out over it up to ``ops.pls.MAX_K``,
float32, ``impl="torch"``) runs through the reduce sweep's bodies
(:func:`~cvmatrix_tpu_torch.models.sweep.cross_validate_reduce` with a
chunk consumer: the hoisted body's LOOCV, packed and v3 fold plans, the
generic per-chunk body, masked batches) on formed fold matrices;
:func:`solve` is that consumer, one ``ops.pls.ikpls2`` call a chunk (one
block a fold), which sends K over ``ops.pls.MAX_K`` (``impl="torch"``
and float32 alone reach it through this function) to the wide route's
``ops.pls.ikpls2_wide`` on formed matrices (the whole card on the chunk, K
unbounded): the hand-written kernels on the card, their plain twin on the
CPU. The bucket's sweep runs in a span ``models.pls.route.<route>``
(``operator``, ``wide_op`` or ``formed``). There is no
float32 kernel: a float32 state on the card needs ``impl="torch"``, which
runs the twin there.
"""

from __future__ import annotations

import operator
from typing import Optional

import numpy as np
import torch

from ..config import CVConfig
from ..core.batch import host_folds, host_mask
from ..core.state import FitState
from ..ops import pls as _pls
from ..ops.loocv import IMPLS, check_rows
from ..utils.profiling import (
    PLS,
    PLS_ROUTE,
    PLS_SOLVE,
    span,
    spanned,
    to_device,
)
from .sweep import ValidationRows, chunking, cross_validate_reduce

__all__ = ["cross_validate_pls", "operator_route", "solve", "solve_operator",
           "solve_wide_operator"]


@spanned(PLS_SOLVE)
def solve(config: CVConfig, mats, stats, rows: ValidationRows, *,
          n_components: int, impl: str = "auto") -> torch.Tensor:
    """One chunk's IKPLS #2 fits and scores -> (F, A, M) weighted PRESS.

    ``mats`` is the chunk's ``(XTX, XTY)`` and ``stats`` its ``(X_mean,
    X_std, Y_mean, Y_std)``, as the sweep's chunk consumer gets them, and
    ``rows`` its :class:`~cvmatrix_tpu_torch.models.sweep.ValidationRows`.
    A fold's prediction of a validation row ``x`` with ``a`` components is
    ``((x - X_mean) / X_std) B_a * Y_std + Y_mean``, each term only where
    its flag is on, with the fold's own training statistics, and
    ``PRESS[a - 1, m]`` the sum over the fold's rows of weight times mask
    times the squared residual of response ``m``. One ``ops.pls.ikpls2``
    call, which solves K over ``ops.pls.MAX_K`` by ``ops.pls.ikpls2_wide``."""
    xtx, xty = mats
    return _pls.ikpls2(
        xtx, xty, rows.X, rows.Y, rows.w, rows.mask, stats,
        n_components=n_components, center_X=config.center_X,
        center_Y=config.center_Y, scale_X=config.scale_X,
        scale_Y=config.scale_Y, impl=impl)


@spanned(PLS + "cross_validate_pls")
def cross_validate_pls(
    config: CVConfig,
    state: FitState,
    idx_batch,
    mask_batch=None,
    *,
    n_components: int,
    batch_size: int = 512,
    impl: str = "auto",
) -> torch.Tensor:
    """The (P, A, M) weighted PRESS of every fold's validation rows for
    1..A = ``n_components`` PLS components, on the state's device.

    ``idx_batch`` is a (P, L) fold-index batch (indices in [-N, N), the
    negative ones wrapped), ``mask_batch`` an optional (P, L) 0/1 mask of
    padded rows; either may be a tensor on any device, as for
    :func:`~cvmatrix_tpu_torch.models.sweep.cross_validate_reduce`, whose
    bodies and chunks of at most ``batch_size`` folds this runs. Each
    fold's model is IKPLS Algorithm #2 on its training ``XTX`` and ``XTY``
    (centred and scaled by the config's flags with the fold's own training
    statistics); ``PRESS[p, a - 1, m]`` is the sum, over fold ``p``'s
    validation rows, of the row's weight (1 unweighted) times its mask
    times ``(y_m - yhat_m)^2``, ``yhat`` predicted with ``a`` components
    (:func:`solve`). ``n_components`` must be at least 1 and at most K and
    the training rows of every fold (N less its validation rows).

    ``impl``: ``"auto"`` takes the operator route for leave-one-out
    batches, the wide operator route for K-fold and masked batches with K
    over ``ops.pls.MAX_OP_K`` and any batch with K over ``ops.pls.MAX_K``
    (:func:`operator_route`), else the sweep's
    hoisted bodies, and the kernels on the card (the twins on the CPU),
    ``"cuda"`` the same and
    requires CUDA tensors, ``"torch"`` the generic body and every twin. The
    kernels are float64 only: a float32 state runs on the CPU, or on the
    card with ``impl="torch"``, and raises otherwise.
    A fold whose component is degenerate (``t^T t`` or ``||XTY q||`` of
    0) reads NaN from that component on; ``ikpls`` stops the fit there.
    """
    if impl not in IMPLS:
        raise ValueError(f"Unknown impl: {impl!r} (auto|cuda|torch).")
    if state.Y is None:
        raise ValueError("Response variables `Y` are not provided.")
    if config.torch_dtype != torch.float64 and (
            impl == "cuda" or (impl == "auto"
                               and state.device.type == "cuda")):
        raise ValueError(
            f"impl={impl!r} on the card needs a float64 config: ikpls2 has "
            "no float32 kernel; pass impl='torch' to run its plain twin.")
    n_components = operator.index(n_components)
    idx = host_folds(idx_batch, state.N)
    mask = host_mask(mask_batch)
    n_val = (idx.shape[1] if mask is None
             else int(np.count_nonzero(mask, axis=1).max(initial=0)))
    n_train = state.N - n_val
    if not 1 <= n_components <= min(state.K, n_train):
        raise ValueError(
            f"n_components={n_components} must be in [1, min(K, training "
            f"rows)] = [1, {min(state.K, n_train)}] (K={state.K}, the "
            f"fewest training rows {n_train}).")

    route = operator_route(config, state, idx, mask, impl)
    with span(PLS_ROUTE + (route or "formed")):
        if route is not None:
            return _operator_sweep(config, state, route, idx, mask,
                                   n_components=n_components,
                                   batch_size=batch_size, impl=impl)

        def consume(mats, stats, rows):
            return solve(config, mats, stats, rows,
                         n_components=n_components, impl=impl)

        return cross_validate_reduce(config, state, idx, mask,
                                     chunk_fn=consume, batch_size=batch_size,
                                     impl=impl)


def operator_route(config: CVConfig, state: FitState, idx: np.ndarray,
                   mask, impl: str) -> Optional[str]:
    """Which route with no fold matrix :func:`cross_validate_pls` takes for
    the host folds ``idx`` (P, L) and ``mask``, both only under ``impl``
    ``"auto"`` or ``"cuda"`` and for a float64 config: ``"operator"`` for
    one unmasked row a fold (LOOCV) and K at most ``ops.pls.MAX_OP_K``,
    else ``"wide_op"`` for K over ``ops.pls.MAX_K``, or for K over
    ``ops.pls.MAX_OP_K`` with more than one row a fold or a mask.
    ``None``: the bucket runs on formed fold matrices through the reduce
    sweep (leave-one-out with K between the two limits among them)."""
    if impl not in ("auto", "cuda") or config.torch_dtype != torch.float64:
        return None
    loocv = idx.shape[1] == 1 and mask is None
    if loocv and state.K <= _pls.MAX_OP_K:
        return "operator"
    if state.K > _pls.MAX_K or (not loocv and state.K > _pls.MAX_OP_K):
        return "wide_op"
    return None


@spanned(PLS_SOLVE)
def solve_operator(config: CVConfig, state: FitState, rows: torch.Tensor, *,
                   n_components: int, impl: str = "auto",
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One chunk of one-row folds -> (F, A, M) weighted PRESS, as
    :func:`solve` scores them, from the fitted state alone:
    ``ops.pls.ikpls2_operator`` applies each fold's training ``XTX`` as
    the fitted total and the fold's rank-one corrections, so no fold
    matrix is formed. ``rows`` is the chunk's (F,) int64 row indices on
    the state's device, checked; the PRESS is written into ``out`` where
    given."""
    return _pls.ikpls2_operator(
        state.XTX, state.XTY, state.X, state.Y, state.weights, _sums(state),
        rows, n_components=n_components, center_X=config.center_X,
        center_Y=config.center_Y, scale_X=config.scale_X,
        scale_Y=config.scale_Y, ddof=config.ddof,
        resolution=config.resolution, impl=impl, out=out)


def _sums(state: FitState) -> tuple:
    """The fit's sums as the operator kernels take them."""
    return (state.sum_X, state.sum_sq_X, state.sum_Y, state.sum_sq_Y,
            state.sum_w, state.num_nonzero_w)


@spanned(PLS_SOLVE)
def solve_wide_operator(config: CVConfig, state: FitState, rows: torch.Tensor,
                        mask: Optional[torch.Tensor], *, n_components: int,
                        impl: str = "auto",
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One chunk of folds of any L -> (F, A, M) weighted PRESS, as
    :func:`solve` scores them, from the fitted state alone:
    ``ops.pls.ikpls2_wide_op`` applies each fold's training ``XTX`` as the
    fitted total less the fold's rank-L validation term, so no fold matrix
    is formed. ``rows`` is the chunk's (F, L) int64 row indices on the
    state's device, checked, ``mask`` its (F, L) float64 mask or ``None``;
    the PRESS is written into ``out`` where given."""
    return _pls.ikpls2_wide_op(
        state.XTX, state.XTY, state.X, state.Y, state.weights, _sums(state),
        rows, mask, n_components=n_components, center_X=config.center_X,
        center_Y=config.center_Y, scale_X=config.scale_X,
        scale_Y=config.scale_Y, ddof=config.ddof,
        resolution=config.resolution, impl=impl, out=out)


def _operator_sweep(config, state, route, idx, mask, *, n_components,
                    batch_size, impl):
    """The routes with no fold matrix (``route`` as :func:`operator_route`
    names it): the rows and mask copied to the state's device once, then
    :func:`solve_operator` or :func:`solve_wide_operator` over chunks of at
    most ``batch_size`` folds, equalised as the reduce sweep equalises them
    (no padding), each writing its folds' rows of the (P, A, M) output."""
    n_folds = idx.shape[0]
    rows = to_device(check_rows(idx, state.N).reshape(idx.shape),
                     state.device)
    if mask is not None:
        mask = to_device(torch.as_tensor(mask, dtype=torch.float64),
                         state.device).reshape(idx.shape)
    bs, _ = chunking(n_folds, state.K, state.K + state.M, batch_size)
    out = torch.empty((n_folds, n_components, state.M),
                      dtype=state.XTX.dtype, device=state.device)
    for c0 in range(0, n_folds, bs):
        c = slice(c0, c0 + bs)
        if route == "operator":
            solve_operator(config, state, rows[c, 0],
                           n_components=n_components, impl=impl, out=out[c])
        else:
            solve_wide_operator(
                config, state, rows[c], None if mask is None else mask[c],
                n_components=n_components, impl=impl, out=out[c])
    return out
