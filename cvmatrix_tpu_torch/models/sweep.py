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
would hold the whole dataset twice). A float32 sweep computes and writes
float32; the chunk rule budgets 8 bytes per element in either dtype, as
the JAX package's does.

``cross_validate`` yields each chunk's per-fold engine results;
``cross_validate_reduce`` maps a user reduction over every fold's matrices
chunk by chunk and keeps only the reductions, or hands each chunk whole to
a chunk consumer with the chunk's validation rows (the port's own:
``models.pls`` fits a PLS model a fold through it). Where the JAX package
compiles one ``lax.scan`` program, the port runs a Python loop of eager
chunks with the same four bodies (the hoisted LOOCV, packed and v3 loops,
and the generic per-chunk body) and the same gates, except that the
hoisted loops run on any device: on the CPU they run the kernels' twins.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..config import CVConfig
from ..core import batch as _batch
from ..core.batch import (
    _f32_kernel_path,
    _large_fold_path,
    _rows_mask,
    downdate_from_operands,
    host_folds,
    host_mask,
    ozaki_v3_from_sources,
    prepare_fold_operands,
    prepare_loocv_sources,
    prepare_ozaki_sources,
    route_kernel,
    run_loocv_route,
    slice_operands,
)
from ..core.fit import fit
from ..core.fold import training_matrices
from ..core.state import FitState
from ..ops.loocv import IMPLS, check_rows
from ..utils.profiling import REDUCE_FN, SOURCES, SWEEP, span, spanned
from .partitioner import Partitioner

__all__ = ["ValidationRows", "chunking", "cross_validate",
           "cross_validate_dict", "cross_validate_reduce", "materialize_cv",
           "materialize_sweep", "sweep_chunking", "sweep_last_chunk"]


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
    if route.startswith("loocv"):
        rows = check_rows(idx[:, 0], state.N)
        if device.type == "cuda":
            rows = rows.pin_memory()  # asynchronous per-chunk copies
        src = prepare_loocv_sources(config, state, rows,
                                    return_XTX=return_XTX,
                                    return_XTY=return_XTY)
        for c in range(n_chunks):
            sl = slice(c * bs, (c + 1) * bs)
            run_loocv_route(config, src, rows[sl], route, src.scal[sl],
                            return_XTY=return_XTY, impl=impl, out=buf)
    elif route in ("packed", "packed_f32"):
        # Host folds: checked on the host once, then moved whole.
        ops, _ = prepare_fold_operands(config, state, idx, mask,
                                       return_XTX=return_XTX,
                                       return_XTY=return_XTY)
        for c in range(n_chunks):
            downdate_from_operands(slice_operands(ops, c * bs, bs),
                                   impl=impl, out=buf)
    elif route in ("v3", "v3_sym"):
        src = prepare_ozaki_sources(config, state, idx, mask,
                                    return_XTX=return_XTX,
                                    return_XTY=return_XTY)
        for c in range(n_chunks):
            ozaki_v3_from_sources(config, slice_operands(src, c * bs, bs),
                                  return_XTY=return_XTY, impl=impl, out=buf)
    else:
        large = (_f32_kernel_path if route == "downdate_f32"
                 else _large_fold_path)
        with span(SOURCES):
            rows, mask_d = _rows_mask(config, state, idx, mask)
            # [XTX | XTY] once for every chunk (3.2 GB at K = 20,000)
            total = _batch._total(state, return_XTX, return_XTY)
        for c in range(n_chunks):
            sl = slice(c * bs, (c + 1) * bs)
            large(config, state, rows[sl],
                  None if mask_d is None else mask_d[sl],
                  return_XTX=return_XTX, return_XTY=return_XTY, impl=impl,
                  out=buf, total=total)
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


class ValidationRows(NamedTuple):
    """A chunk's validation rows on the state's device, as a chunk consumer
    of :func:`cross_validate_reduce` gets them: ``X`` (F, L, K) and ``Y``
    (F, L, M) (``None`` without Y) unweighted, ``w`` (F, L) the rows'
    weights (``None`` unweighted) and ``mask`` (F, L) the fold mask in the
    config dtype (``None`` unmasked)."""

    X: torch.Tensor
    Y: Optional[torch.Tensor]
    w: Optional[torch.Tensor]
    mask: Optional[torch.Tensor]


def _validation_rows(state: FitState, rows: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> ValidationRows:
    """The rows ``rows`` (F, L), on the state's device and checked, gathered
    from the state: one gather of X, of Y and of the weights."""
    return ValidationRows(
        state.X[rows], None if state.Y is None else state.Y[rows],
        None if state.weights is None else state.weights[rows, 0], mask)


def _reducer(reduce_fn):
    """``reduce_fn`` as the reduce bodies' chunk consumer ``consume(mats,
    stats, rows)``: mapped over the chunk's folds; it never calls ``rows``,
    so no validation row is gathered."""
    return lambda mats, stats, rows: _vmap_reduce(reduce_fn, mats, stats)


def _copied_rows(config, state, idx, mask):
    """``(c0, size) -> ValidationRows`` of the folds ``idx[c0:c0 + size]``,
    gathered by rows (and the mask) copied to the state's device at the
    first call: once a sweep, and never in a sweep that asks for none."""
    held = []

    def chunk(c0, size):
        if not held:
            with span(SOURCES):
                held.append(_rows_mask(config, state, idx, mask))
        rows, mask_d = held[0]
        return _validation_rows(state, rows[c0:c0 + size],
                                _slice(mask_d, c0, size))
    return chunk


def _split_mats(out, k: int, return_XTX: bool, return_XTY: bool):
    if return_XTX and return_XTY:
        return out[:, :, :k], out[:, :, k:]
    return out


def _slice(t, start: int, size: int):
    return None if t is None else t[start:start + size]


def _slice_stats(stats, start: int, size: int):
    return tuple(_slice(s, start, size) for s in stats)


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

    ``impl``: ``"auto"`` takes the JAX package's hoisted loops where its
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
    bs = min(batch_size, n_folds)
    # Equalise chunk sizes: padding to a multiple of a near-n chunk size
    # can almost double the sweep (n=1000, bs=953 -> padded to 1906).
    n_chunks = -(-n_folds // bs)
    bs = -(-n_folds // n_chunks)
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
    padded (n_chunks * bs, L) batch, by the first of the JAX package's four
    bodies whose gate holds; ``rows()`` gathers the chunk's
    :class:`ValidationRows`, only where it is called."""
    is_f64 = _batch._is_f64(config)
    n_total, n_l = idx.shape
    hoist = impl in ("auto", "cuda")
    # LOOCV: the sources once for every fold, then the LOOCV kernel per
    # chunk (JAX sweep.py:224-235).
    if (hoist and mask is None and n_l == 1 and return_XTX
            and _batch.loocv_single_tile_ok(config, state, return_XTX,
                                            return_XTY)):
        return _loocv_reduce_loop(config, state, idx, bs, consume,
                                  return_XTY, impl)
    # Small folds: the packed operands once for every fold (:243-259).
    threshold = (_batch.large_fold_threshold(config, state, return_XTX,
                                             return_XTY)
                 if is_f64 else _batch.LARGE_FOLD_ROWS)
    if (hoist and _batch._hoist_reduce_enabled() and n_l < threshold
            and _batch._hoisted_operand_bytes(
                state, n_total, n_l, return_XTX, return_XTY)
            <= _batch._HOIST_BUDGET_BYTES):
        return _smallfold_reduce_loop(config, state, idx, mask, bs,
                                      consume, return_XTX, return_XTY,
                                      impl)
    # Mid-band: the v3 sources and statistics once for every fold
    # (:267-281).
    if (hoist and _batch._hoist_reduce_enabled() and is_f64 and return_XTX
            and n_l >= threshold
            and _batch.ozaki_v3_ok(config, state, return_XTX, return_XTY,
                                   n_l)
            and _batch._v3_hoist_bytes(state, n_total, n_l)
            <= _batch._HOIST_BUDGET_BYTES):
        return _v3_reduce_loop(config, state, idx, mask, bs, consume,
                               return_XTY, impl)
    # Generic body: every chunk through training_matrices_batched, with
    # [XTX | XTY] built once for every chunk (3.2 GB at K = 20,000).
    with span(SOURCES):
        total = _batch._total(state, return_XTX, return_XTY)
    rows_of = _copied_rows(config, state, idx, mask)
    out = []
    for c0 in range(0, n_total, bs):
        mats, stats = _batch.training_matrices_batched(
            config, state, idx[c0:c0 + bs],
            None if mask is None else mask[c0:c0 + bs],
            return_XTX=return_XTX, return_XTY=return_XTY, impl=impl,
            total=total)
        out.append(consume(mats, stats, lambda: rows_of(c0, bs)))
    return out


def _loocv_reduce_loop(config, state, idx, bs, consume, return_XTY,
                       impl, n_rows_total=None):
    """Hoisted-source LOOCV reduce sweep (JAX ``sweep.py:314``): one
    :func:`prepare_loocv_sources` for every fold, then per chunk the LOOCV
    kernel (symmetric under ``sym_loocv``, two folds per block under the
    x2 knob when the chunk is even: no bump here), which also stores the
    chunk's statistics, and ``consume`` (rows gathered by the sources'
    device rows; :func:`_reduce_sweep_impl`). ``n_rows_total``: the global
    row count where ``state`` is one rank's row shard (the mesh path)."""
    rows = check_rows(idx[:, 0], state.N)
    if state.device.type == "cuda":
        rows = rows.pin_memory()  # asynchronous per-chunk copies
    src = prepare_loocv_sources(config, state, rows, return_XTX=True,
                                return_XTY=return_XTY,
                                n_rows_total=n_rows_total)
    route = route_kernel(config, state, 1, True, return_XTY, False,
                         n_folds=bs)
    out = []
    for c0 in range(0, rows.shape[0], bs):
        mats, stats = run_loocv_route(
            config, src, rows[c0:c0 + bs], route, src.scal[c0:c0 + bs],
            return_XTY=return_XTY, impl=impl, return_stats=True)
        out.append(consume(
            _split_mats(mats, state.K, True, return_XTY), stats,
            lambda: _validation_rows(state, src.rows[c0:c0 + bs], None)))
        # freed before the next chunk allocates its own
        del mats, stats
    return out


def _smallfold_reduce_loop(config, state, idx, mask, bs, consume,
                           return_XTX, return_XTY, impl, blocks_stats=None):
    """Hoisted-prep small-fold reduce sweep (JAX ``sweep.py:453``):
    :func:`prepare_fold_operands` once for every fold (of ``idx``/``mask``,
    or of gathered ``blocks_stats``: the mesh path), then per chunk the
    packed kernel on sliced operands and ``consume`` over sliced
    statistics (rows copied to the device once, where it asks for them)."""
    ops, stats = prepare_fold_operands(config, state, idx, mask,
                                       return_XTX=return_XTX,
                                       return_XTY=return_XTY,
                                       blocks_stats=blocks_stats)
    rows_of = _copied_rows(config, state, idx, mask)
    out = []
    for c0 in range(0, ops.u.shape[0], bs):
        mats = downdate_from_operands(slice_operands(ops, c0, bs), impl=impl)
        out.append(consume(
            _split_mats(mats, state.K, return_XTX, return_XTY),
            _slice_stats(stats, c0, bs), lambda: rows_of(c0, bs)))
    return out


def _v3_reduce_loop(config, state, idx, mask, bs, consume, return_XTY,
                    impl, blocks_stats=None):
    """Hoisted-source mid-band reduce sweep (JAX ``sweep.py:390``):
    :func:`prepare_ozaki_sources` and the statistics once for every fold
    (or :func:`~cvmatrix_tpu_torch.core.batch.ozaki_sources_from_blocks`
    of gathered ``blocks_stats``: the mesh path), then per chunk the v3
    kernel (symmetric under ``sym_loocv``) on sliced sources and
    ``consume`` (rows gathered by the sources' device rows)."""
    if blocks_stats is None:
        src = prepare_ozaki_sources(config, state, idx, mask,
                                    return_XTX=True, return_XTY=return_XTY)
        stats = _batch._summed_stats(
            config, state, src.rows, src.mask,
            **_batch._stat_flags(config, True, return_XTY))[:4]
    else:
        src = _batch.ozaki_sources_from_blocks(
            config, state, *blocks_stats, return_XTY=return_XTY)
        stats = blocks_stats[1][:4]
    out = []
    for c0 in range(0, src.rows.shape[0], bs):
        mats = ozaki_v3_from_sources(config, slice_operands(src, c0, bs),
                                     return_XTY=return_XTY, impl=impl)
        out.append(consume(
            _split_mats(mats, state.K, True, return_XTY),
            _slice_stats(stats, c0, bs),
            lambda: _validation_rows(state, src.rows[c0:c0 + bs],
                                     _slice(src.mask, c0, bs))))
    return out
