"""Fold sweeps, PyTorch port: the materialising sweeps and the reduce sweeps.

Counterpart of :mod:`cvmatrix_tpu.models.sweep`.

``materialize_sweep`` and ``materialize_cv`` compute EVERY fold's training
matrices in device memory, chunk by chunk into one reused buffer, and
return a probe scalar. The chunk size follows the JAX package's rule (a
4 GB budget, at most 2000 folds, chunks equalised and the last fold
repeated to fill the last chunk; bumped to an even count when the dtype's
two-folds-per-block knob is on, as the JAX sweep bumps it on the TPU).

Every fold batch, float64 or float32, takes the kernel route that
:func:`~cvmatrix_tpu_torch.core.batch.route_kernel` picks by the JAX
package's gates and routing policy: the hand-written kernel on CUDA, its
plain twin on the CPU or with ``impl="torch"``. The LOOCV, packed (both
dtypes) and v3 routes build their operands once for all folds and slice
them per chunk; the large-fold routes (Ozaki-df64, ``bmm`` plus epilogue,
and the float32 engine's ``fused_downdate``) build ``[XTX | XTY]`` once
and gather and reduce chunk by chunk (hoisting L-row blocks for every fold
would hold the whole dataset twice): either way ``core.batch``'s fold
plan, built once a sweep and run a chunk at a time. A float32 sweep
computes and writes float32; the chunk rule budgets 8 bytes per element in
either dtype, as the JAX package's does.

``cross_validate`` yields each chunk's per-fold engine results;
``cross_validate_reduce`` maps a user reduction over every fold's matrices
chunk by chunk and keeps only the reductions, or hands each chunk whole to
a chunk consumer with the chunk's validation rows (the port's own:
``models.pls`` fits a PLS model a fold through it). Where the JAX package
compiles one ``lax.scan`` program, the port runs a Python loop of eager
chunks with the same bodies and gates: the hoisted body (one fold plan of
the LOOCV, packed or v3 route for every fold, then the kernel a chunk) and
the generic per-chunk body, except that the hoisted body runs on any
device: on the CPU it runs the kernels' twins.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..config import CVConfig
from ..core import batch as _batch
from ..core.batch import ValidationRows, host_folds, host_mask, route_kernel
from ..core.fit import fit
from ..core.fold import training_matrices
from ..core.state import FitState
from ..ops.loocv import IMPLS
from ..utils.profiling import REDUCE_FN, SOURCES, SWEEP, span, spanned
from .partitioner import Partitioner

__all__ = ["ValidationRows", "chunking", "cross_validate",
           "cross_validate_dict", "cross_validate_reduce", "materialize_cv",
           "materialize_sweep", "sweep_chunking", "sweep_last_chunk"]


def chunking(n_folds: int, k: int, c: int, batch_size: Optional[int] = None,
             hbm_budget_bytes: float = 4e9) -> Tuple[int, int]:
    """``(bs, n_chunks)``: the JAX package's chunk rule for (K, C) outputs
    (``k`` and ``c`` read only without a ``batch_size``). The chunks are
    equalised: padding to a multiple of a near-n chunk size can almost
    double a sweep (n=1000, bs=953 -> padded to 1906)."""
    if batch_size is None:
        per_fold = 2 * 8 * max(k * c, 1)
        batch_size = max(1, min(2000, int(hbm_budget_bytes / per_fold)))
    bs = min(batch_size, n_folds)
    n_chunks = -(-n_folds // bs)
    bs = -(-n_folds // n_chunks)
    return bs, n_chunks


def sweep_chunking(config: CVConfig, n_folds: int, k: int, c: int,
                   batch_size: Optional[int] = None,
                   hbm_budget_bytes: float = 4e9) -> Tuple[int, int]:
    """``(bs, n_chunks)`` of a materialising sweep: :func:`chunking`, with
    the chunk bumped to an even fold count when the dtype's x2 knob
    (``df64x2`` or ``f32x2``) is on (JAX ``sweep.py:569-574``), and the
    chunk count of the folds padded to a multiple of it."""
    bs, _ = chunking(n_folds, k, c, batch_size, hbm_budget_bytes)
    x2 = (_batch._df64x2_enabled() if _batch._is_f64(config)
          else _batch._f32x2_enabled())
    if x2 and bs % 2:
        bs += 1  # the two-folds-per-block kernels take an even chunk
    return bs, -(-n_folds // bs)


def _pad_folds(idx, mask, bs):
    """Pad the fold axis to a multiple of ``bs`` by repeating the last fold."""
    pad = (-idx.shape[0]) % bs
    if pad:
        idx = np.concatenate([idx, np.repeat(idx[-1:], pad, axis=0)])
        if mask is not None:
            mask = np.concatenate([mask, np.repeat(mask[-1:], pad, axis=0)])
    return idx, mask


def sweep_last_chunk(config: CVConfig, idx_batch, k: int, c: int,
                     batch_size: Optional[int] = None,
                     hbm_budget_bytes: float = 4e9) -> np.ndarray:
    """The last chunk of folds that :func:`materialize_sweep` runs over the
    (F, L) ``idx_batch`` at (K, C) = (k, c), padded as the sweep pads it
    to (bs, L). Its first fold is the one whose matrices give the sweep's
    probe."""
    idx = np.asarray(idx_batch)
    bs, n_chunks = sweep_chunking(config, idx.shape[0], k, c, batch_size,
                                  hbm_budget_bytes)
    idx, _ = _pad_folds(idx, None, bs)
    return idx[(n_chunks - 1) * bs:]


@spanned(SWEEP + "materialize_sweep")
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

    ``idx_batch`` is an (F, L) fold-index batch (or (F,) for one-row folds)
    with indices in [-N, N) (the negative ones wrapped), ``mask_batch`` an
    optional (F, L) 0/1 mask; either may be a tensor on any device.
    Returns a 0-d tensor on the device: element [0, 0] of XTX plus element
    [0, 0] of XTY of the last chunk's first fold (what the JAX package's
    sweep returns; :func:`sweep_last_chunk` names that chunk). Reading it
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
    idx = host_folds(idx_batch, state.N)
    mask = host_mask(mask_batch)
    k = state.K
    m = (state.M or 0) if return_XTY else 0
    bs, n_chunks = sweep_chunking(config, idx.shape[0], k,
                                  (k if return_XTX else 0) + m, batch_size,
                                  hbm_budget_bytes)
    idx, mask = _pad_folds(idx, mask, bs)

    route = route_kernel(config, state, idx.shape[1], return_XTX,
                         return_XTY, mask is not None, n_folds=bs)
    buf = torch.empty((bs, k, (k if return_XTX else 0) + m),
                      dtype=config.torch_dtype, device=device)
    plan = _batch._plan(config, state, route, idx, mask,
                        return_XTX=return_XTX, return_XTY=return_XTY,
                        impl=impl, with_stats=False)
    for c0 in range(0, n_chunks * bs, bs):
        plan.run(c0, bs, out=buf)
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
    ``device`` as in :func:`~cvmatrix_tpu_torch.core.fit.fit`: by default a
    tensor ``X``'s device, else the CUDA card.
    """
    state = fit(config, X, Y, weights, validate=validate, copy=False,
                device=device)
    return materialize_sweep(
        config, state, idx_batch, mask_batch, batch_size=batch_size,
        impl=impl, return_XTX=return_XTX, return_XTY=return_XTY,
        hbm_budget_bytes=hbm_budget_bytes,
    )


# --------------------------------------------------------------------------- #
# Reduce sweeps                                                               #
# --------------------------------------------------------------------------- #


def _auto_batch(n_folds: int, k: int, m: int, itemsize: int,
                budget_bytes: float) -> int:
    per_fold = (k * k + k * m + 4 * (k + m)) * itemsize
    # x3: outputs live while the next chunk is produced, plus gather temps.
    return max(1, min(n_folds, int(budget_bytes / (3 * per_fold))))


def cross_validate(
    config: CVConfig,
    state: FitState,
    partitioner: Partitioner,
    *,
    return_XTX: bool = True,
    return_XTY: bool = True,
    batch_size: Optional[int] = None,
    hbm_budget_bytes: float = 4e9,
    use_padding: bool = False,
) -> Iterator[Tuple[list, object]]:
    """Yield ``(fold_keys, results)`` per chunk, covering all folds.

    ``results`` has the structure of :func:`~cvmatrix_tpu_torch.core.fold.
    training_matrices` with a leading fold axis: the per-fold engine run on
    an (F, L) batch. With ``use_padding=True`` all folds form one padded,
    masked batch (``Partitioner.padded_batches``); otherwise one batch per
    fold size (``Partitioner.size_buckets``).
    """
    k = state.K
    m = state.M or 0
    itemsize = np.dtype(config.dtype).itemsize
    if use_padding:
        groups = [partitioner.padded_batches()]
    else:
        groups = [(ks, batch, None) for ks, batch in
                  partitioner.size_buckets()]
    for keys, idx, mask in groups:
        bs = batch_size or _auto_batch(len(keys), k, m, itemsize,
                                       hbm_budget_bytes)
        for s in range(0, len(keys), bs):
            yield keys[s:s + bs], training_matrices(
                config, state, idx[s:s + bs],
                None if mask is None else mask[s:s + bs],
                return_XTX=return_XTX, return_XTY=return_XTY)


def cross_validate_dict(
    config: CVConfig,
    state: FitState,
    partitioner: Partitioner,
    **kw,
) -> Dict[Hashable, object]:
    """Materialise :func:`cross_validate` into a fold -> result dict."""
    out: Dict[Hashable, object] = {}
    for keys, res in cross_validate(config, state, partitioner, **kw):
        for i, key in enumerate(keys):
            out[key] = pytree.tree_map(lambda a: a[i], res)
    return out


@spanned(REDUCE_FN)
def _vmap_reduce(reduce_fn, mats, stats):
    """``reduce_fn`` over the fold axis of one chunk (``torch.func.vmap``;
    ``None`` statistics pass through unbatched). A reduction that is a view
    of the chunk's matrices (``xty[:, 0]``) or statistics is copied, so
    that it does not hold the chunk's (F, K, C) output, or the buffer the
    LOOCV kernel stores the statistics in, alive until the sweep ends: the
    JAX sweep keeps only the reductions."""
    def dims(tree):
        return pytree.tree_map(
            lambda a: 0 if isinstance(a, torch.Tensor) else None, tree,
            is_leaf=lambda a: a is None)

    res = torch.func.vmap(reduce_fn, in_dims=(dims(mats), dims(stats)))(
        mats, stats)
    held = {a.untyped_storage().data_ptr()
            for a in pytree.tree_leaves((mats, stats))
            if isinstance(a, torch.Tensor)}
    return pytree.tree_map(
        lambda a: a.clone() if isinstance(a, torch.Tensor)
        and a.untyped_storage().data_ptr() in held else a, res)


def _reducer(reduce_fn):
    """``reduce_fn`` as the reduce bodies' chunk consumer ``consume(mats,
    stats, rows)``: mapped over the chunk's folds; it never calls ``rows``,
    so no validation row is gathered."""
    return lambda mats, stats, rows: _vmap_reduce(reduce_fn, mats, stats)


@spanned(SWEEP + "cross_validate_reduce")
def cross_validate_reduce(
    config: CVConfig,
    state: FitState,
    idx_batch,
    mask_batch=None,
    *,
    reduce_fn=None,
    return_XTX: bool = True,
    return_XTY: bool = True,
    batch_size: int = 512,
    impl: str = "auto",
    donate_state: bool = False,
    chunk_fn=None,
):
    """Map ``reduce_fn`` over every fold's training matrices on the state's
    device; only the reductions are kept. Or, with ``chunk_fn`` instead,
    hand each chunk to it whole.

    ``idx_batch`` is a (P, L) fold-index batch (indices in [-N, N), the
    negative ones wrapped), ``mask_batch`` an optional (P, L) 0/1 mask of
    padded rows (see ``Partitioner.padded_batches``); either may be a
    tensor on any device.
    ``reduce_fn(matrices, stats)`` is applied per fold through
    ``torch.func.vmap`` over each chunk of at most ``batch_size`` folds:
    ``matrices`` is ``(XTX, XTY)`` or the one requested matrix and
    ``stats`` the ``(X_mean, X_std, Y_mean, Y_std)`` tuple (``None`` where
    not computed) of one fold, as in :func:`~cvmatrix_tpu_torch.core.batch.
    training_matrices_batched`; it returns a tensor or a pytree of tensors.
    The fold axis is padded to a multiple of an equalised chunk by
    repeating the last fold, and the padded results are dropped. Returns
    the reductions stacked along a leading axis of P.

    ``chunk_fn(matrices, stats, rows)`` (the port's own; pass it instead of
    ``reduce_fn``) is called once a chunk of F folds, padded ones included,
    with the chunk's batched ``matrices`` and ``stats`` as
    :func:`~cvmatrix_tpu_torch.core.batch.training_matrices_batched`
    returns them and its :class:`ValidationRows`, gathered on the device
    once a chunk (the hoisted LOOCV and v3 bodies gather from their
    sources' device rows, the others from rows copied to the device once a
    sweep); it returns a tensor or a pytree of tensors with a leading axis
    of F, which are stacked and trimmed as the reductions are. Without it
    the sweep gathers no rows.

    ``impl``: ``"auto"`` takes the JAX package's hoisted body where its
    gates allow (kernels on CUDA, twins on the CPU), ``"cuda"`` the same
    and requires CUDA tensors, ``"torch"`` the generic per-chunk body with
    the twins (the JAX ``"xla"``). ``donate_state`` is accepted for
    signature parity and does nothing: torch cannot take buffers from the
    caller, who frees the state by dropping its last reference.
    """
    del donate_state
    if impl not in IMPLS:
        raise ValueError(f"Unknown impl: {impl!r} (auto|cuda|torch).")
    if (reduce_fn is None) == (chunk_fn is None):
        raise ValueError("Pass one of `reduce_fn` and `chunk_fn`.")
    if chunk_fn is None:
        consume = _reducer(reduce_fn)
    else:
        def consume(mats, stats, rows):
            return chunk_fn(mats, stats, rows())
    if not return_XTX and not return_XTY:
        raise ValueError(
            "At least one of `return_XTX` and `return_XTY` must be True."
        )
    if return_XTY and state.Y is None:
        raise ValueError("Response variables `Y` are not provided.")
    if impl == "cuda" and state.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors; the state is on "
                         f"{state.device}.")
    idx = host_folds(idx_batch, state.N)
    mask = host_mask(mask_batch)
    n_folds = idx.shape[0]
    bs, _ = chunking(n_folds, state.K, (state.K if return_XTX else 0)
                     + ((state.M or 0) if return_XTY else 0), batch_size)
    idx, mask = _pad_folds(idx, mask, bs)
    chunks = _reduce_sweep_impl(config, state, idx, mask, bs, consume,
                                return_XTX, return_XTY, impl)
    return pytree.tree_map(lambda a: a[:n_folds], _stack_chunks(chunks))


def _stack_chunks(chunks):
    """The per-chunk reductions (a list of pytrees) concatenated along the
    fold axis."""
    leaves0, spec = pytree.tree_flatten(chunks[0])
    return pytree.tree_unflatten(
        [torch.cat(parts) for parts in zip(
            leaves0, *(pytree.tree_flatten(c)[0] for c in chunks[1:]))],
        spec)


def _reduce_sweep_impl(config, state, idx, mask, bs, consume, return_XTX,
                       return_XTY, impl):
    """The per-chunk outputs of ``consume(mats, stats, rows)`` over the
    padded (n_chunks * bs, L) batch, by the first of the JAX package's
    bodies whose gate holds; ``rows()`` gathers the chunk's
    :class:`ValidationRows`, only where it is called."""
    n_total, n_l = idx.shape
    route = route_kernel(config, state, n_l, return_XTX, return_XTY,
                         mask is not None, n_folds=bs)
    # Hoisted body: the route's fold plan once for every fold (JAX
    # sweep.py:224-281), where the plan builder's gate holds.
    if impl in ("auto", "cuda"):
        plan = _batch._plan(config, state, route, idx, mask,
                            return_XTX=return_XTX, return_XTY=return_XTY,
                            impl=impl, hoist=True)
        if plan is not None:
            return _run_chunks(plan, n_total, bs, consume)
    # Generic body: every chunk through training_matrices_batched, with
    # [XTX | XTY] built once for every chunk (3.2 GB at K = 20,000).
    with span(SOURCES):
        total = _batch._total(state, return_XTX, return_XTY)
    rows_of = _batch._copied_rows(config, state, idx, mask)
    out = []
    for c0 in range(0, n_total, bs):
        mats, stats = _batch.training_matrices_batched(
            config, state, idx[c0:c0 + bs], _batch._slice(mask, c0, bs),
            return_XTX=return_XTX, return_XTY=return_XTY, impl=impl,
            total=total)
        out.append(consume(mats, stats, lambda: rows_of(c0, bs)))
        # freed before the next chunk allocates its own
        del mats, stats
    return out


def _run_chunks(plan, n_folds: int, bs: int, consume) -> list:
    """The hoisted body's loop, the mesh layer's too: ``consume(mats, stats,
    rows)`` of each chunk of ``bs`` folds (the last may be short) that the
    fold plan ``plan`` runs over ``n_folds`` folds."""
    out = []
    for c0 in range(0, n_folds, bs):
        mats, stats = plan.run(c0, bs)
        out.append(consume(mats, stats, lambda: plan.rows(c0, bs)))
        # freed before the next chunk allocates its own
        del mats, stats
    return out
