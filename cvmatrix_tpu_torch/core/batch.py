"""Batched fold operands, kernel routing and the fold-batch engine, PyTorch port.

Counterpart of :mod:`cvmatrix_tpu.core.batch`: the routing gates
(:func:`route_kernel`), the LOOCV sources (with the small-fold route on
them, :func:`smallfold_from_sources`, to which no gate routes, as in the
JAX package), the packed factor-form operands
(:func:`prepare_fold_operands`), the v3 sources
(:func:`prepare_ozaki_sources`), the large-fold paths (float64 and the
float32 engine's) and :func:`training_matrices_batched`, and the mesh
layer's entries on gathered blocks (:func:`batched_matrices_from_blocks`
with :func:`stats_from_blocks`, :func:`loocv_sources_from_blocks`,
:func:`ozaki_sources_from_blocks` and the ``blocks_stats=`` forms of the
operand builders), which route as the JAX package's do. The JAX package
packs these operands as padded f32 (hi, lo) pairs and int8 mantissa slices
for its TPU kernels; the port keeps them as unpadded tensors in the config
dtype, which the H100 kernels read directly: a float32 config runs every
route in float32, as the JAX package's f32 engine does. Padding survives
only inside the gates, so that both packages send the same fold batch to
the same kernel.

Every entry runs its route through one fold plan (``_plan``): the route's
operands built once for a batch of folds by the builders above, then run
a chunk of folds at a time. The batched entries run a plan's one chunk,
the sweeps (``models.sweep``) and the mesh layer many.

Fold rows are range-checked once per call of an entry
(``ops.loocv.check_rows``): on the host where they arrive as host data,
with one device sync where the operand builders (``prepare_*``) are handed
CUDA rows. Host rows and masks reach the device once a call, each through
one pinned, non-blocking copy (``utils.profiling.to_device``), so that no
call waits for the card and the host builds the next chunk while the last
one's kernel runs. The LOOCV sources keep the rows they checked, on the
device: the LOOCV kernels and :func:`smallfold_from_sources` take slices of
them unchecked, and check only other CUDA rows. The kernel routes skip the
per-fold validity raises (the JAX package's ``check=False``), so no route
synchronises the device per chunk.
The batched entries
(:func:`training_matrices_batched` and the sweeps) take fold indices in
[-N, N) and wrap the negative ones on the host, as NumPy indexing, the
per-fold engine and the JAX package's XLA engine do; the kernels see
[0, N) only.

The routing policy (:mod:`cvmatrix_tpu_torch.policy`) is read at each call:
``sym_loocv`` sends float64 LOOCV and v3 batches to the symmetric kernels,
``df64x2``/``f32x2`` send LOOCV batches of an even fold count to two folds
per block, as the JAX package's accessors (``_sym_enabled`` and siblings)
do at trace time.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import CVConfig
from ..ops import fold_downdate as _fd
from ..ops import loocv as _loocv
from ..ops.precision import highest_precision
from ..policy import policy as _policy
from ..utils.profiling import ROUTE, SOURCES, STATS, span, spanned, to_device
from .fold import (
    FoldBlocks,
    _compute_training_stats,
    gather_val_blocks,
    training_matrices_from_blocks,
)
from .state import FitState

__all__ = [
    "FUSED_LARGE_FOLD_ROWS",
    "LARGE_FOLD_ROWS",
    "TPU_KERNELS",
    "FoldOperands",
    "LoocvSources",
    "OzakiSources",
    "batched_matrices_from_blocks",
    "downdate_from_operands",
    "host_folds",
    "host_mask",
    "large_fold_threshold",
    "loocv_from_sources",
    "loocv_single_tile_ok",
    "loocv_sources_from_blocks",
    "loocv_sym_tile",
    "ozaki_sources_from_blocks",
    "ozaki_trim_groups",
    "ozaki_v3_from_sources",
    "ozaki_v3_ok",
    "prepare_fold_operands",
    "prepare_loocv_sources",
    "prepare_ozaki_sources",
    "route_kernel",
    "run_loocv_route",
    "slice_operands",
    "smallfold_from_sources",
    "stats_from_blocks",
    "training_matrices_batched",
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
    (F, 3) per-fold ``[sw_train, 1/sw_train, 1/divisor]`` stream,
    ``mask`` the (F, L) row mask in the config dtype or ``None`` (the JAX
    package's ``mrow``) and ``rows`` the (F, L) fold rows, range-checked
    when the sources were built: :func:`smallfold_from_sources` takes
    slices of them without checking them again.
    """

    total: torch.Tensor
    xw: torch.Tensor
    xu: torch.Tensor
    yu: Optional[torch.Tensor]
    yw: Optional[torch.Tensor]
    gx: torch.Tensor
    gy: Optional[torch.Tensor]
    scal: torch.Tensor
    mask: Optional[torch.Tensor] = None
    rows: Optional[torch.Tensor] = None


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


def _scalars(config: CVConfig, sw_t: torch.Tensor,
             nnz_t: torch.Tensor) -> torch.Tensor:
    """(F, 3) ``[sw_train, 1/sw_train, 1/divisor]`` from the training
    weight sums and nonzero counts; the divisor stays in floating point."""
    divisor = (nnz_t - config.ddof) * sw_t / nnz_t
    return torch.stack([sw_t, 1.0 / sw_t, 1.0 / divisor], dim=1)


def _fold_scalar_stream(config: CVConfig, state: FitState,
                        rows: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        n_rows_total: Optional[int] = None) -> torch.Tensor:
    """(F, 3) per-fold ``[sw_train, 1/sw_train, 1/divisor]`` for fold rows
    (F,) or (F, L) and an optional (F, L) mask: the scalars of
    ``fold._train_weight_scalars`` and ``fold._std_divisor`` with
    reciprocals taken outside the kernels.

    ``n_rows_total`` replaces ``state.N`` in the unweighted, unmasked count
    downdate: on a row shard (``parallel.distributed``) the state holds
    this rank's rows only, and the count must be the global one."""
    dt = config.torch_dtype
    rows = rows.reshape(rows.shape[0], -1)
    f_folds, n_l = rows.shape
    if state.weights is not None:
        wv = state.weights[rows, 0]
        if mask is not None:
            wv = wv * mask
        sw_t = state.sum_w - wv.sum(dim=1)
        nnz_t = (state.num_nonzero_w - torch.count_nonzero(wv, dim=1)).to(dt)
    elif mask is not None:
        sw_t = state.sum_w - mask.sum(dim=1)
        nnz_t = sw_t
    else:
        n_total = state.N if n_rows_total is None else n_rows_total
        sw_t = torch.full((f_folds,), n_total - n_l, dtype=dt,
                          device=state.device)
        nnz_t = sw_t
    return _scalars(config, sw_t, nnz_t)


def _fold_scalar_stream_from_blocks(config: CVConfig, state: FitState,
                                    blocks: FoldBlocks) -> torch.Tensor:
    """:func:`_fold_scalar_stream` of gathered blocks (JAX
    ``core/batch.py:1681``): the weights come from ``blocks.w_val``
    (masked already) and not from a dataset gather, and an unweighted,
    unmasked fold removes its L rows from ``state.sum_w``, the global
    count, so the globals-only state of the mesh path serves."""
    dt = config.torch_dtype
    f_folds, n_l = blocks.Xv_w.shape[:2]
    if blocks.w_val is not None:
        wv = blocks.w_val[..., 0]
        sw_t = state.sum_w - wv.sum(dim=1)
        nnz_t = (state.num_nonzero_w - torch.count_nonzero(wv, dim=1)).to(dt)
    elif blocks.mask is not None:
        sw_t = state.sum_w - blocks.mask.sum(dim=1)
        nnz_t = sw_t
    else:
        sw_t = (state.sum_w - n_l).to(dt).expand(f_folds)
        nnz_t = sw_t
    return _scalars(config, sw_t, nnz_t)


def _stat_rows(like: torch.Tensor, sum_vec, sq_vec, width: int):
    """(2, width) ``[sum, sum_sq]`` of one side, zeros where unused."""
    g = like.new_zeros((2, width))
    if sum_vec is not None:
        g[0] = sum_vec[0]
    if sq_vec is not None:
        g[1] = sq_vec[0]
    return g


def _loocv_sources(config: CVConfig, state: FitState, xw, xu, yu, yw,
                   weighted: bool, return_XTY: bool, scal_fn, mask,
                   rows) -> LoocvSources:
    """Assemble :class:`LoocvSources` from row streams: ``xw``/``xu`` the
    weighted and unweighted X rows, ``yu``/``yw`` the Y rows and their
    weighted form; the global sums, the total and (through ``scal_fn``)
    the per-fold scalars where the flags need them."""
    center = config.center_X or (return_XTY and config.center_Y)
    need_x_mean = center or config.scale_X
    need_y_stats = return_XTY and (
        config.center_X or config.center_Y or config.scale_Y
    )
    xw = xw.contiguous()
    xu = xu.contiguous() if weighted else xw
    gx = _stat_rows(xw, state.sum_X if need_x_mean else None,
                    state.sum_sq_X if config.scale_X else None, state.K)
    if return_XTY:
        yu = yu.contiguous()
        yw = yw.contiguous() if (weighted and need_y_stats) else yu
        gy = _stat_rows(xw, state.sum_Y if need_y_stats else None,
                        state.sum_sq_Y if config.scale_Y else None, state.M)
        total = torch.cat([state.XTX, state.XTY], dim=1)
    else:
        yu = yw = gy = None
        total = state.XTX.contiguous()
    scal = (scal_fn() if (need_x_mean or need_y_stats)
            else xw.new_zeros((rows.shape[0], 3)))
    return LoocvSources(total, xw, xu, yu, yw, gx, gy, scal, mask, rows)


@spanned(SOURCES)
def prepare_loocv_sources(
    config: CVConfig,
    state: FitState,
    idx_batch,
    mask_batch=None,
    *,
    return_XTX: bool = True,
    return_XTY: bool = True,
    n_rows_total: Optional[int] = None,
) -> LoocvSources:
    """Build the operands of the LOOCV kernels for the folds ``idx_batch``
    ((F,) or (F, L) row indices, checked against ``[0, N)``) and an
    optional (F, L) 0/1 ``mask_batch``.

    One-row unmasked folds run through :func:`loocv_from_sources`; folds
    of more rows, or with a mask, through :func:`smallfold_from_sources`
    (the port of ``fused_smallfold_df64``). ``n_rows_total`` is the global
    row count where ``state`` holds one rank's row shard (see
    :func:`_fold_scalar_stream`).
    """
    idx = idx_batch if isinstance(idx_batch, torch.Tensor) else np.asarray(
        idx_batch)
    f_folds = idx.shape[0]
    n_l = 1 if idx.ndim == 1 else idx.shape[1]
    if not loocv_single_tile_ok(config, state, return_XTX, return_XTY):
        raise ValueError(
            f"single-tile geometry required (K={state.K}, M={state.M}); "
            "check loocv_single_tile_ok before preparing sources"
        )
    if return_XTY and state.Y is None:
        raise ValueError("Response variables `Y` are not provided.")
    # a copy, so that no later write to the caller's tensor reaches rows
    # that count as checked (on a card the pinned copy, which waits for no
    # stream)
    rows = to_device(_loocv.check_rows(idx, state.N), state.device,
                     copy=True)
    rows = rows.reshape(f_folds, n_l)
    weighted = state.weights is not None
    mask = None if mask_batch is None else to_device(torch.as_tensor(
        mask_batch, dtype=config.torch_dtype), state.device
    ).reshape(f_folds, n_l).contiguous()
    return _loocv_sources(
        config, state, state.WX if weighted else state.X, state.X, state.Y,
        state.WY, weighted, return_XTY,
        lambda: _fold_scalar_stream(config, state, rows, mask, n_rows_total),
        mask, rows)


def loocv_sources_from_blocks(config: CVConfig, state: FitState,
                              blocks: FoldBlocks, *,
                              return_XTY: bool) -> LoocvSources:
    """:class:`LoocvSources` of gathered one-row blocks (JAX
    ``core/batch.py:1875``).

    The mesh LOOCV route: the LOOCV kernels gather rows by index from
    dataset-wide streams, and a batch of one-row blocks is such a stream,
    so they run unchanged with ``rows = arange(F)``. The globals come from
    the state, the rows from the blocks, and weightedness from the blocks
    (``w_val``): the mesh path's globals-only state has no weights. Masked
    blocks raise (a masked one-row fold takes another route).
    """
    if blocks.mask is not None:
        raise ValueError("masked blocks cannot take the LOOCV kernels")
    f_folds = blocks.Xv_w.shape[0]
    weighted = blocks.w_val is not None
    yu = yw = None
    if return_XTY:
        yu, yw = blocks.Yv_u[:, 0], blocks.Yv_w[:, 0]
    rows = torch.arange(f_folds, device=blocks.Xv_w.device)[:, None]
    return _loocv_sources(
        config, state, blocks.Xv_w[:, 0], blocks.Xv_u[:, 0], yu, yw,
        weighted, return_XTY,
        lambda: _fold_scalar_stream_from_blocks(config, state, blocks),
        None, rows)


def _loocv_flags(config: CVConfig, return_XTY: bool) -> dict:
    return dict(center_xtx=config.center_X,
                center_xty=config.center_X or config.center_Y,
                scale_x=config.scale_X, scale_y=config.scale_Y,
                with_y=return_XTY, resolution=config.resolution)


def loocv_from_sources(config: CVConfig, src: LoocvSources, rows,
                       scal_slice=None, *, return_XTY: bool,
                       two_per_step: bool = False, sym: bool = False,
                       impl: str = "auto", out=None,
                       return_stats: bool = False):
    """Run the LOOCV downdate on (a slice of) prepared sources.

    Returns (F, K, C) with ``XTX = out[..., :K]`` and ``XTY = out[..., K:]``;
    with ``return_stats``, ``(out, stats)``: the folds' training statistics
    as :func:`_loocv_stats` returns them, stored by the kernel's vector
    phase (``ops.loocv.fused_loocv``).
    ``two_per_step`` launches two folds per block (the ports of
    ``fused_loocv_df64x2`` and ``fused_loocv_f32x2``): the same arithmetic.
    ``sym`` (float64) runs the port of ``fused_loocv_df64_sym``: the X
    block's upper triangle computed, its strictly lower part the mirror,
    the XTY columns computed. ``impl``: ``"auto"`` (the kernel on CUDA, the
    twin on CPU), ``"cuda"`` or ``"torch"``. Sources with a mask, or rows that are not one per
    fold, raise: the LOOCV kernels read one unmasked row a fold.
    """
    scal = src.scal if scal_slice is None else scal_slice
    n_rows = (rows.numel() if isinstance(rows, torch.Tensor)
              else np.asarray(rows).size)
    if src.mask is not None or n_rows != scal.shape[0]:
        raise ValueError(
            f"{n_rows} rows for {scal.shape[0]} folds"
            f"{' with a mask' if src.mask is not None else ''}: the LOOCV "
            "kernels read one unmasked row a fold; run folds of more rows, "
            "or masked ones, through smallfold_from_sources."
        )
    res = _loocv.fused_loocv(
        src, rows, scal, sym=sym, folds_per_block=2 if two_per_step else 1,
        impl=impl, out=out, return_stats=return_stats,
        **_loocv_flags(config, return_XTY))
    if not return_stats:
        return res
    out, stats = res
    return out, _loocv_stats(config, stats, src.xw.shape[1], return_XTY)


def _loocv_stats(config: CVConfig, stats: torch.Tensor, k: int,
                 return_XTY: bool):
    """``(X_mean, X_std, Y_mean, Y_std)`` of the LOOCV kernels' (F, 2, C)
    statistics: (F, 1, K) and (F, 1, M) views of it, ``None`` where
    :func:`_stat_flags` asks for no such statistic, as the per-fold
    engine's batched result has them."""
    flags = _stat_flags(config, True, return_XTY)
    x, y = stats[:, :, :k], stats[:, :, k:]
    return (x[:, 0:1] if flags["return_X_mean"] else None,
            x[:, 1:2] if flags["return_X_std"] else None,
            y[:, 0:1] if flags["return_Y_mean"] else None,
            y[:, 1:2] if flags["return_Y_std"] else None)


def smallfold_from_sources(config: CVConfig, src: LoocvSources, rows,
                           scal_slice=None, mask_slice=None, *, n_l: int,
                           return_XTY: bool, has_mask: bool,
                           impl: str = "auto", out=None) -> torch.Tensor:
    """Run the small-fold downdate (the port of ``fused_smallfold_df64``)
    on (a slice of) prepared sources -> (F, K, C) in the config dtype, with
    ``XTX = out[..., :K]`` and ``XTY = out[..., K:]``.

    ``rows`` are the folds' rows in [0, N), (F * L,) fold-major as in the
    JAX function or (F, L): ``src.rows`` or a slice of it (checked when the
    sources were built, so a sweep pays no sync a chunk), or other rows on
    the host or the device (checked here, device rows with one sync);
    ``scal_slice`` and ``mask_slice`` are the matching slices of
    ``src.scal`` and ``src.mask`` for a chunk (the whole streams when
    ``None``). ``has_mask`` applies the mask (the weighted side only).
    ``route_kernel`` and the sweeps never route here, as in the JAX
    package. ``impl`` as in :func:`loocv_from_sources`.
    """
    rows = torch.as_tensor(rows)
    # host rows are checked by the wrapper, views of src.rows were checked
    if rows.device.type != "cpu" and not _loocv.shares_storage(rows,
                                                               src.rows):
        _loocv.check_rows(rows, src.xw.shape[0])
    if rows.numel() % n_l:
        raise ValueError(
            f"flat index count {rows.numel()} is not a multiple of the fold "
            f"size {n_l}")
    rows = rows.reshape(-1, n_l)
    mask = None
    if has_mask:
        mask = src.mask if mask_slice is None else mask_slice
        if mask is None:
            raise ValueError("has_mask=True needs sources prepared with a "
                             "mask (or a mask_slice).")
    return _fd.fold_smallfold(
        src.total, src.xw, src.xu, src.yu, src.yw, src.gx, src.gy, rows,
        mask, src.scal if scal_slice is None else scal_slice, impl=impl,
        out=out, **_loocv_flags(config, return_XTY))


def run_loocv_route(config: CVConfig, src: LoocvSources, rows, route: str,
                    scal_slice=None, *, return_XTY: bool, impl: str = "auto",
                    out=None, return_stats: bool = False):
    """One of :func:`route_kernel`'s three LOOCV routes on prepared
    sources: ``"loocv_sym"``, ``"loocv_x2"`` or ``"loocv"``;
    ``return_stats`` as in :func:`loocv_from_sources`."""
    return loocv_from_sources(config, src, rows, scal_slice,
                              return_XTY=return_XTY,
                              two_per_step=route == "loocv_x2",
                              sym=route == "loocv_sym", impl=impl, out=out,
                              return_stats=return_stats)


# --------------------------------------------------------------------------- #
# Routing: the JAX package's gates, so both packages pick the same kernel     #
# --------------------------------------------------------------------------- #

# Folds of at least this many rows leave the packed route (JAX
# batch.py:970-971): 10 where the fused Ozaki kernels apply, else 32.
LARGE_FOLD_ROWS = 32
FUSED_LARGE_FOLD_ROWS = 10
# The Ozaki slice width (the JAX package's precise._T_BITS); with the
# policy's trim budget it gates v3 by fold size.
_OZAKI_T_BITS = 6

# route_kernel's routes and the TPU kernel each one ports
TPU_KERNELS = {
    "loocv": "fused_loocv_df64 (cvmatrix_tpu/ops/kernels.py:892); in "
             "float32 fused_loocv_f32 (cvmatrix_tpu/ops/kernels.py:1826)",
    "loocv_x2": "fused_loocv_df64x2 (cvmatrix_tpu/ops/kernels.py:1003); in "
                "float32 fused_loocv_f32x2 "
                "(cvmatrix_tpu/ops/kernels.py:1980)",
    "loocv_sym": "fused_loocv_df64_sym (cvmatrix_tpu/ops/kernels.py:1190)",
    "v3_sym": "fused_ozaki_downdate_v3_sym "
              "(cvmatrix_tpu/ops/kernels.py:2430)",
    "packed": "fused_downdate_df64_packed (cvmatrix_tpu/ops/kernels.py:382)",
    "packed_f32": "fused_downdate_f32_packed "
                  "(cvmatrix_tpu/ops/kernels.py:630)",
    "downdate_f32": "fused_downdate (cvmatrix_tpu/ops/kernels.py:105)",
    "v3": "fused_ozaki_downdate_v3 (cvmatrix_tpu/ops/kernels.py:2333)",
    "ozaki_df64": "fused_ozaki_downdate_df64 (cvmatrix_tpu/ops/kernels.py:1385)",
    "epilogue": "fused_epilogue_df64 (cvmatrix_tpu/ops/kernels.py:531)",
}


def _is_f64(config: CVConfig) -> bool:
    return np.dtype(config.dtype).itemsize == 8


def _exact(config: CVConfig) -> bool:
    # The JAX package's _use_exact on its TPU, where "auto" is exact for f64.
    return config.matmul_mode in ("auto", "exact")


def _sym_enabled() -> bool:
    return _policy().sym_loocv


def _f32x2_enabled() -> bool:
    return _policy().f32x2


def _df64x2_enabled() -> bool:
    return _policy().df64x2


def _hoist_reduce_enabled() -> bool:
    return _policy().hoist_reduce


def loocv_sym_tile(kp: int):
    """The JAX package's tile for its symmetric kernels, or ``None`` where
    it runs the full ones (JAX ``core/batch.py:631``): at least two tiles
    per side of the padded width ``kp``. The port mirrors at element
    granularity and needs no tile; the gate keeps both packages on the
    same route."""
    if kp >= 512 and kp % 256 == 0:
        return 256
    if kp >= 256 and kp % 128 == 0:
        return 128
    return None


def _sym_applies(config: CVConfig, k: int) -> bool:
    """Whether ``sym_loocv`` routes a float64 batch of ``k`` X columns to
    the symmetric kernels (the width is padded as the JAX sources pad)."""
    return (_sym_enabled() and _is_f64(config)
            and loocv_sym_tile(_round_up(max(k, 8), 128)) is not None)


def ozaki_trim_groups(n_l: int, *, n_slices: int = 10,
                      budget_log2: Optional[int] = None) -> int:
    """Slice-product groups the JAX v3 kernel keeps for a fold of ``n_l``
    rows (JAX ``ops/kernels.py:2083``), under the policy's
    ``ozaki_budget_log2`` unless ``budget_log2`` is given; only the v3
    gate and the reduce sweep's hoist estimate read it here."""
    if budget_log2 is None:
        budget_log2 = _policy().ozaki_budget_log2
    lp = _round_up(max(n_l, 1), 32)
    for sp in range(2, n_slices):
        if (1.2 * (sp + 1) * lp * 2.0 ** (-_OZAKI_T_BITS * sp)
                <= 2.0 ** budget_log2):
            return sp
    return n_slices


def _padded_dims(state: FitState, return_XTX: bool, return_XTY: bool):
    """``(k, c, kp, cp)``: the JAX large-fold kernels' padded geometry."""
    k = state.K
    c = (k if return_XTX else 0) + ((state.M or 0) if return_XTY else 0)
    blk = 128 if max(k, c) > 4096 else 512
    kp = _round_up(max(k, 8), 128)
    cp = _round_up(max(c, 8), 128)
    return k, c, _round_up(kp, min(blk, kp)), _round_up(cp, min(blk, cp))


def _fused_ozaki_eligible(config, state, return_XTX, return_XTY) -> bool:
    k = state.K
    c = k + ((state.M or 0) if return_XTY else 0)
    kp = _round_up(max(k, 8), 128)
    cp = _round_up(max(c, 8), 128)
    return (return_XTX and kp == cp and kp <= 512 and _is_f64(config)
            and _exact(config))


def large_fold_threshold(config: CVConfig, state: FitState,
                         return_XTX: bool, return_XTY: bool) -> int:
    """Fold rows from which a batch leaves the packed route."""
    if _fused_ozaki_eligible(config, state, return_XTX, return_XTY):
        return FUSED_LARGE_FOLD_ROWS
    return LARGE_FOLD_ROWS


def ozaki_v3_ok(config: CVConfig, state: FitState, return_XTX: bool,
                return_XTY: bool, n_l: int) -> bool:
    """The v3 gate: one square tile of at most 512 and a fold size whose
    TPU group sums stay exact in f32 (``Sp * Lp * 65^2 < 2^24``)."""
    lp = _round_up(n_l, 32)
    return (
        loocv_single_tile_ok(config, state, return_XTX, return_XTY)
        and _is_f64(config) and _exact(config)
        and _round_up(max(state.K, 8), 128) <= 512
        and ozaki_trim_groups(n_l) * lp * 65 * 65 < 2 ** 24
    )


def _use_fused(config, state, return_XTX, return_XTY, n_l) -> bool:
    """The ``use_fused`` test of the JAX large-fold path (batch.py:1097)."""
    _, _, kp, cp = _padded_dims(state, return_XTX, return_XTY)
    return kp == cp and kp <= 512 and n_l <= 1024 and _exact(config)


def route_kernel(config: CVConfig, state: FitState, n_l: int,
                 return_XTX: bool, return_XTY: bool, masked: bool, *,
                 n_folds: Optional[int] = None) -> str:
    """The route, by its TPU kernel, of a batch of folds of ``n_l`` rows.

    A key of :data:`TPU_KERNELS` (which names each route's kernel), chosen by
    the JAX package's gates: one-row unmasked folds on one tile take the
    LOOCV kernel (in either dtype): ``"loocv_sym"`` in float64 under the
    policy's ``sym_loocv`` where :func:`loocv_sym_tile` applies (sym wins),
    else ``"loocv_x2"`` under the dtype's x2 knob when ``n_folds`` is even
    (``None``: a sweep chunk, which the materialising sweeps bump even),
    else ``"loocv"``. Float32 batches then take the f32 engine's kernels:
    the packed one under ``LARGE_FOLD_ROWS``, else ``fused_downdate``.
    Float64 batches take the packed kernel under
    :func:`large_fold_threshold`, then v3 where :func:`ozaki_v3_ok`
    (``"v3_sym"`` under ``sym_loocv`` as for LOOCV), the Ozaki-df64 kernel
    where the large-fold path fuses, else a product plus the epilogue
    kernel.
    """
    if n_l == 1 and not masked and loocv_single_tile_ok(
            config, state, return_XTX, return_XTY):
        if _sym_applies(config, state.K):
            return "loocv_sym"
        x2 = _df64x2_enabled() if _is_f64(config) else _f32x2_enabled()
        if x2 and (n_folds is None or n_folds % 2 == 0):
            return "loocv_x2"
        return "loocv"
    if not _is_f64(config):
        return "downdate_f32" if n_l >= LARGE_FOLD_ROWS else "packed_f32"
    if n_l < large_fold_threshold(config, state, return_XTX, return_XTY):
        return "packed"
    if ozaki_v3_ok(config, state, return_XTX, return_XTY, n_l):
        return "v3_sym" if _sym_applies(config, state.K) else "v3"
    if _use_fused(config, state, return_XTX, return_XTY, n_l):
        return "ozaki_df64"
    return "epilogue"


# --------------------------------------------------------------------------- #
# Gathers and statistics                                                      #
# --------------------------------------------------------------------------- #


def _stat_flags(config: CVConfig, return_XTX: bool, return_XTY: bool):
    """Cross-coupled stat gating (the per-fold engine's rule)."""
    return dict(
        return_X_mean=config.center_X or (return_XTY and config.center_Y),
        return_X_std=config.scale_X,
        return_Y_mean=return_XTY and (config.center_X or config.center_Y),
        return_Y_std=return_XTY and config.scale_Y,
    )


@spanned(STATS)
def stats_from_blocks(config: CVConfig, state: FitState, blocks: FoldBlocks,
                      return_XTX: bool = True, return_XTY: bool = True):
    """``(X_mean, X_std, Y_mean, Y_std, sum_w_train)`` of batched gathered
    blocks, without the validity raise (JAX ``core/batch.py:805``)."""
    return _compute_training_stats(
        config, state, blocks, check=False,
        **_stat_flags(config, return_XTX, return_XTY))


def _gather_and_stats(config, state, rows, mask, return_XTX, return_XTY):
    """Batched blocks and :func:`stats_from_blocks` of (F, L) device rows
    already checked on the host."""
    blocks = gather_val_blocks(config, state, rows, mask, return_XTY)
    return blocks, stats_from_blocks(config, state, blocks, return_XTX,
                                     return_XTY)


@spanned(STATS)
@highest_precision()
def _summed_stats(config, state, rows, mask, **flags):
    """``_compute_training_stats`` of (F, L) device rows, gathering each
    side's unweighted rows once, for the routes whose kernels gather the
    rows themselves.

    A fold's sums are a batched mat-vec of its rows with each row's weight
    times mask (``Xv_w = X[v] w m``); the squared sums square the gather
    in place. Against :func:`_gather_and_stats` (four blocks, two of them
    weighted) this took 1.03 against 1.51 ms and 0.41 against 1.22 GB for
    100 folds of 1,000 rows at N=100,000, K=500, M=10 (NVIDIA H100 80GB
    HBM3, 700 W).
    """
    w_val = coef = None
    if state.weights is not None:
        w_val = state.weights[rows]
        if mask is not None:
            w_val = w_val * mask[..., None]
        coef = w_val.mT
    elif mask is not None:
        coef = mask[:, None]

    def fold_sum(t):  # (F, L, W) -> (F, 1, W)
        return t.sum(dim=1, keepdim=True) if coef is None else torch.bmm(
            coef, t)

    # Y stats are requested only where the weighted Y side is WY
    # (config.needs_WY), so both sides take the same coefficients.
    val_sums = [None] * 4
    for i, (table, mean, std) in enumerate((
            (state.X, flags["return_X_mean"], flags["return_X_std"]),
            (state.Y, flags["return_Y_mean"], flags["return_Y_std"]))):
        if mean or std:
            v = table[rows]
            val_sums[2 * i] = fold_sum(v)
            if std:
                val_sums[2 * i + 1] = fold_sum(v.square_())
    blocks = FoldBlocks(Xv_w=state.X.new_empty((*rows.shape, 0)), Xv_u=None,
                        Yv_w=None, Yv_u=None, w_val=w_val, mask=mask)
    return _compute_training_stats(config, state, blocks, check=False,
                                   val_sums=val_sums, **flags)


def host_folds(idx_batch, n: int) -> np.ndarray:
    """(F, L) fold indices on the host from an (F,) or (F, L) batch (NumPy,
    a list, or a tensor on any device), checked against [-n, n) and the
    negative ones wrapped, as NumPy indexing and the per-fold engine take
    them (``core/fold._as_index``); the entries of the batched engine and
    the sweeps read their folds through it."""
    idx = np.asarray(idx_batch.cpu() if isinstance(idx_batch, torch.Tensor)
                     else idx_batch)
    if idx.ndim == 1:
        idx = idx[:, None]
    if idx.dtype.kind not in "iu":
        raise TypeError(f"fold rows must be integers, got {idx.dtype}")
    if idx.size:
        lo, hi = int(idx.min()), int(idx.max())
        if lo < -n or hi >= n:
            raise ValueError(f"fold rows outside [-{n}, {n}) (min {lo}, max "
                             f"{hi}).")
        if lo < 0:
            idx = np.where(idx < 0, idx + n, idx)
    return idx


def host_mask(mask_batch):
    """The (F, L) fold mask on the host (NumPy, a list, or a tensor on any
    device), or ``None``."""
    if mask_batch is None:
        return None
    return np.asarray(mask_batch.cpu() if isinstance(mask_batch, torch.Tensor)
                      else mask_batch)


def _rows_mask(config, state, idx_batch, mask_batch):
    """(F, L) int64 rows and the optional mask on the state's device, rows
    range-checked against [0, N): on the host for host rows, with one
    device sync for device rows."""
    if isinstance(idx_batch, torch.Tensor) and idx_batch.device.type != "cpu":
        _loocv.check_rows(idx_batch, state.N)
    rows = _fd.device_rows(idx_batch, state.N, state.device)
    mask = None if mask_batch is None else to_device(torch.as_tensor(
        mask_batch, dtype=config.torch_dtype), state.device
    ).reshape(rows.shape).contiguous()
    return rows, mask


def _total(state: FitState, return_XTX: bool, return_XTY: bool):
    if return_XTX and return_XTY:
        return torch.cat([state.XTX, state.XTY], dim=1)
    return (state.XTX if return_XTX else state.XTY).contiguous()


def _xy_concat(x_part, y_part):
    parts = [t for t in (x_part, y_part) if t is not None]
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


def _pack_kc_vectors(like, k, c, *, i1=None, i2=None, p_vec=None,
                     q_vec=None):
    """``kvec`` (F, 2, K) = [p, i1] and ``cvec`` (F, 2, C) = [q, i2]; p, q
    default to 0 and i1, i2 to 1, so every epilogue applies all four."""
    f_folds = like.shape[0]
    kvec = like.new_zeros((f_folds, 2, k))
    cvec = like.new_zeros((f_folds, 2, c))
    kvec[:, 1] = 1.0 if i1 is None else i1
    cvec[:, 1] = 1.0 if i2 is None else i2
    if p_vec is not None:
        kvec[:, 0] = p_vec
    if q_vec is not None:
        cvec[:, 0] = q_vec
    return kvec, cvec


# --------------------------------------------------------------------------- #
# Packed route (fused_downdate_df64_packed)                                   #
# --------------------------------------------------------------------------- #


class FoldOperands(NamedTuple):
    """Factor-form operands of the packed kernel for a batch of folds.

    ``total`` (K, C); ``u`` (F, L, K) the weighted, masked X rows times
    r1; ``v`` (F, L, C) the unweighted ``[X | Y]`` rows times
    ``[r1 | r2]``; ``kvec`` (F, 2, K) ``[p, i1]`` with p = sw mX r1;
    ``cvec`` (F, 2, C) ``[q, i2]`` with q the means times r (zeroed per
    side that is not centred). r is 1/std, or 1 where a side is unscaled.
    """

    total: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    kvec: torch.Tensor
    cvec: torch.Tensor


FoldOperands.PER_FOLD = ("u", "v", "kvec", "cvec")


@spanned(SOURCES)
def prepare_fold_operands(
    config: CVConfig,
    state: FitState,
    idx_batch,
    mask_batch=None,
    *,
    return_XTX: bool = True,
    return_XTY: bool = True,
    blocks_stats=None,
):
    """``(FoldOperands, stats)`` for a batch of folds: (F, L) rows in
    [0, N), on the host or the device (checked either way, device rows with
    one sync), and an optional (F, L) mask. ``blocks_stats=(blocks,
    stats5)`` builds them from gathered :class:`FoldBlocks` and their
    :func:`stats_from_blocks` instead (the mesh path; ``idx_batch`` is then
    ignored).

    Gathers, downdated statistics, reciprocal stds and factor scaling run
    here, once: sweeps build the operands for every fold and slice the
    fold axis per chunk (:func:`slice_operands`). The math is the factor
    form of the reference epilogue::

        out = total (.) (r1 (x) r2) - sum_l (xv_l r1) (x) (m2_l r2)
            - (sw mean1 r1) (x) (mean2 r2)
    """
    if blocks_stats is None:
        rows, mask = _rows_mask(config, state, idx_batch, mask_batch)
        blocks_stats = _gather_and_stats(config, state, rows, mask,
                                         return_XTX, return_XTY)
    blocks, (X_mean, X_std, Y_mean, Y_std, sw) = blocks_stats
    k = state.K
    m = (state.M or 0) if return_XTY else 0
    c = (k if return_XTX else 0) + m
    f_folds = blocks.Xv_w.shape[0]
    r1 = 1.0 / X_std if config.scale_X else None                # (F, 1, K)
    r2y = 1.0 / Y_std if (return_XTY and config.scale_Y) else None
    center_xtx = config.center_X
    center_xty = config.center_X or config.center_Y
    center = (return_XTX and center_xtx) or (return_XTY and center_xty)
    scale = config.scale_X or (return_XTY and config.scale_Y)

    def times(rows_, r):
        return rows_ if r is None else rows_ * r

    u = times(blocks.Xv_w, r1).contiguous()
    v = _xy_concat(
        times(blocks.Xv_u, r1) if return_XTX else None,
        times(blocks.Yv_u, r2y) if return_XTY else None,
    ).contiguous()
    ones = u.new_ones((f_folds, 1))
    i1 = i2 = p_vec = q_vec = None
    if scale:
        i1 = None if r1 is None else r1[:, 0]
        i2 = _xy_concat(
            (ones.expand(-1, k) if r1 is None else r1[:, 0])
            if return_XTX else None,
            (ones.expand(-1, m) if r2y is None else r2y[:, 0])
            if return_XTY else None,
        )
    if center:
        mX = X_mean[:, 0]
        p_vec = times(sw.reshape(-1, 1) * mX, None if r1 is None else r1[:, 0])
        qy = None
        if return_XTY:
            qy = (times(Y_mean[:, 0], None if r2y is None else r2y[:, 0])
                  if center_xty else ones.new_zeros((f_folds, m)))
        q_vec = _xy_concat(
            (times(mX, None if r1 is None else r1[:, 0]) if center_xtx
             else ones.new_zeros((f_folds, k))) if return_XTX else None,
            qy,
        )
    kvec, cvec = _pack_kc_vectors(u, k, c, i1=i1, i2=i2, p_vec=p_vec,
                                  q_vec=q_vec)
    ops = FoldOperands(_total(state, return_XTX, return_XTY), u, v, kvec,
                       cvec)
    return ops, (X_mean, X_std, Y_mean, Y_std)


def downdate_from_operands(ops: FoldOperands, *, impl: str = "auto",
                           out=None) -> torch.Tensor:
    """The packed downdate of prepared operands -> (F, K, C)."""
    return _fd.fold_packed(ops.total, ops.u, ops.v, ops.kvec, ops.cvec,
                           impl=impl, out=out)


def slice_operands(ops, start: int, size: int):
    """Fold-axis slice of :class:`FoldOperands` or :class:`OzakiSources`
    (views: no copy)."""
    return ops._replace(**{
        name: getattr(ops, name)[start:start + size]
        for name in ops.PER_FOLD if getattr(ops, name) is not None
    })


# --------------------------------------------------------------------------- #
# v3 route (fused_ozaki_downdate_v3)                                          #
# --------------------------------------------------------------------------- #


class OzakiSources(NamedTuple):
    """Operands of the v3 kernel.

    Dataset-wide: ``total`` (K, C), ``xw``/``xu`` the (N, K) weighted and
    unweighted X rows, ``yu`` the (N, M) Y rows (``None`` without the XTY
    side), ``gx`` (2, K) ``[sum_X, sum_sq_X]`` (zeros where unused). Per
    fold: ``rows`` (F, L) int64 and ``mask`` (F, L) or ``None``, ``sxv``
    (F, K) exact column sums of the weighted, masked rows, ``yvec`` (F, 2,
    C) whose Y columns hold the q part and the i2 part, ``scal`` (F, 3).
    The JAX package's int8 dataset planes, their scales and the 32-row
    padding have no counterpart: the kernel gathers float64 rows.
    """

    total: torch.Tensor
    xw: torch.Tensor
    xu: torch.Tensor
    yu: Optional[torch.Tensor]
    gx: torch.Tensor
    rows: torch.Tensor
    mask: Optional[torch.Tensor]
    sxv: torch.Tensor
    yvec: torch.Tensor
    scal: torch.Tensor


OzakiSources.PER_FOLD = ("rows", "mask", "sxv", "yvec", "scal")


def prepare_ozaki_sources(
    config: CVConfig,
    state: FitState,
    idx_batch,
    mask_batch=None,
    *,
    return_XTX: bool = True,
    return_XTY: bool = True,
) -> OzakiSources:
    """Build the v3 kernel's operands for the folds ``idx_batch`` (F, L),
    rows in [0, N) on the host or the device (checked either way, device
    rows with one sync), and an optional (F, L) mask.

    The X-side column sums, the (M-wide) Y-side statistics and the O(F)
    scalars are computed here, per fold; the kernel derives the X-side
    squared sums, means and stds itself.
    """
    return _ozaki_sources_and_stats(config, state, idx_batch, mask_batch,
                                    return_XTX, return_XTY,
                                    with_stats=False)[0]


@spanned(SOURCES)
def _ozaki_sources_and_stats(config, state, idx_batch, mask_batch,
                             return_XTX, return_XTY, *, with_stats):
    """``(OzakiSources, stats)``: :func:`prepare_ozaki_sources`' sources
    and, ``with_stats``, the folds' ``(X_mean, X_std, Y_mean, Y_std)`` by
    :func:`_stat_flags` (else ``None``). One :func:`_summed_stats` call
    gives both the statistics and the sources' Y side: it sums each side
    by itself, so the numbers are those of a call a side."""
    if not return_XTX:
        raise ValueError("the v3 route requires return_XTX=True; check "
                         "route_kernel before preparing sources")
    if return_XTY and state.Y is None:
        raise ValueError("Response variables `Y` are not provided.")
    rows, mask = _rows_mask(config, state, idx_batch, mask_batch)
    xw = state.X if state.weights is None else state.WX
    stats = None
    if with_stats:
        flags = _stat_flags(config, True, return_XTY)
        # the sources' Y side needs the Y mean wherever a Y statistic is
        summed = _summed_stats(config, state, rows, mask, **dict(
            flags, return_Y_mean=flags["return_Y_mean"]
            or flags["return_Y_std"]))
        stats = (*summed[:2], summed[2] if flags["return_Y_mean"] else None,
                 summed[3])

        def y_stats():
            return summed[2:4]
    else:
        def y_stats():
            return _summed_stats(
                config, state, rows, mask, return_X_mean=False,
                return_X_std=False, return_Y_mean=True,
                return_Y_std=config.scale_Y)[2:4]
    return _ozaki_sources(
        config, state, xw, state.X, state.Y, rows, mask, return_XTY,
        # Per-fold row sums without an (F, L, K) gather. Fits v3's folds
        # of at most a few hundred rows: per 910 folds of 10 rows 0.031 ms
        # against 0.044 ms for gather and sum, but 16 ms against 0.7 ms for
        # 3 folds of 33,334 rows (K=500, NVIDIA H100 80GB HBM3, 700 W).
        lambda: torch.nn.functional.embedding_bag(
            rows, xw, per_sample_weights=mask, mode="sum"),
        y_stats,
        lambda: _fold_scalar_stream(config, state, rows, mask)), stats


def _ozaki_sources(config, state, xw, xu, yu, rows, mask, return_XTY,
                   sums_fn, y_stats_fn, scal_fn) -> OzakiSources:
    """Assemble :class:`OzakiSources` from the row streams and the folds'
    (F, L) ``rows`` and ``mask``: ``sums_fn()`` gives the (F, K) column
    sums of the weighted, masked rows, ``y_stats_fn()`` the folds'
    ``(Y_mean, Y_std)``, ``scal_fn()`` the scalars, each called only where
    the flags need it."""
    f_folds, k = rows.shape[0], state.K
    m = state.M if return_XTY else 0
    center = config.center_X or (return_XTY and config.center_Y)
    need_x_mean = center or config.scale_X
    need_y_stats = return_XTY and (
        config.center_X or config.center_Y or config.scale_Y
    )
    sxv = sums_fn() if need_x_mean else xw.new_zeros((f_folds, k))
    gx = _stat_rows(xw, state.sum_X if need_x_mean else None,
                    state.sum_sq_X if config.scale_X else None, k)
    yvec = xw.new_zeros((f_folds, 2, k + m))
    if need_y_stats:
        Y_mean, Y_std = y_stats_fn()
        if config.center_X or config.center_Y:
            yvec[:, 0, k:] = Y_mean[:, 0]
        yvec[:, 1, k:] = 1.0 / Y_std[:, 0] if config.scale_Y else 1.0
    elif return_XTY and config.scale_X:
        yvec[:, 1, k:] = 1.0  # i2's Y part is 1 when only X is scaled
    scal = (scal_fn() if (need_x_mean or need_y_stats)
            else xw.new_zeros((f_folds, 3)))
    return OzakiSources(
        _total(state, True, return_XTY), xw.contiguous(), xu.contiguous(),
        yu.contiguous() if return_XTY else None, gx, rows, mask, sxv, yvec,
        scal,
    )


def _block_stream(blocks: FoldBlocks, return_XTY: bool):
    """``(xw, xu, yu, rows)``: gathered (F, L, .) blocks as (F * L, .) row
    streams and the (F, L) rows ``arange(F * L)`` that read them back, for
    the kernels that gather rows by index; ``xw`` is weighted and masked
    already, so the kernels take no mask."""
    f_folds, n_l, _ = blocks.Xv_w.shape

    def flat(t):
        return t.reshape(f_folds * n_l, t.shape[-1]).contiguous()

    rows = torch.arange(f_folds * n_l, device=blocks.Xv_w.device)
    return (flat(blocks.Xv_w), flat(blocks.Xv_u),
            flat(blocks.Yv_u) if return_XTY else None,
            rows.reshape(f_folds, n_l))


def ozaki_sources_from_blocks(config: CVConfig, state: FitState,
                              blocks: FoldBlocks, stats5, *,
                              return_XTY: bool) -> OzakiSources:
    """:class:`OzakiSources` of gathered blocks and their
    :func:`stats_from_blocks` (the port of ``ozaki_operands_from_blocks``,
    JAX ``core/batch.py:1781``).

    The JAX function slices the blocks into int8 operands for its TPU
    kernel; here the v3 kernel gathers the blocks' rows as it gathers the
    dataset's (:func:`_block_stream`: rows ``arange(F * L)``, checked
    against the stream's F * L rows where they are on the host). The
    column sums, the Y-side vectors and the scalars come from the blocks
    and their statistics, as in the JAX function.
    """
    xw, xu, yu, rows = _block_stream(blocks, return_XTY)
    return _ozaki_sources(
        config, state, xw, xu, yu, rows, None, return_XTY,
        lambda: blocks.Xv_w.sum(dim=1), lambda: stats5[2:4],
        lambda: _fold_scalar_stream_from_blocks(config, state, blocks))


def ozaki_v3_from_sources(config: CVConfig, src: OzakiSources, *,
                          return_XTY: bool, impl: str = "auto",
                          out=None) -> torch.Tensor:
    """Run the v3 downdate on (a slice of) prepared sources -> (F, K, C).

    Under the policy's ``sym_loocv``, where :func:`loocv_sym_tile` applies,
    the symmetric v3 kernel runs (port of ``fused_ozaki_downdate_v3_sym``;
    the JAX switch is in its ``ozaki_v3_from_sources``).
    """
    return _fd.fold_v3(
        src.total, src.xw, src.xu, src.yu, src.rows, src.mask, src.gx,
        src.sxv, src.yvec, src.scal,
        center_xtx=config.center_X,
        center_xty=config.center_X or config.center_Y,
        scale_x=config.scale_X, scale_y=config.scale_Y, with_y=return_XTY,
        resolution=config.resolution,
        sym=_sym_applies(config, src.total.shape[0]), impl=impl, out=out,
    )


# Device memory a reduce sweep's whole-sweep operand hoist may take (the
# JAX package's value and estimates, so that both packages take the same
# loop; the estimates count the JAX package's padded pair and int8 layouts).
_HOIST_BUDGET_BYTES = 4e9


def _hoisted_operand_bytes(state, n_folds, n_l, return_XTX,
                           return_XTY) -> int:
    """The JAX estimate of :func:`prepare_fold_operands`' hoisted streams
    (JAX ``core/batch.py:1006``)."""
    _, _, kp, cp = _padded_dims(state, return_XTX, return_XTY)
    return 8 * n_folds * (n_l + 2) * (kp + cp)


def _v3_blocks_hoist_bytes(state, n_folds, n_l) -> int:
    """The JAX estimate of a blocks-built hoisted v3 sweep's resident bytes
    per device (JAX ``core/batch.py:1029``), the mesh path's gate."""
    kp = _round_up(max(state.K, 8), 128)
    n_sp = ozaki_trim_groups(n_l)
    int8_streams = 2 * n_sp * n_folds * _round_up(n_l, 32) * kp
    blocks = 2 * n_folds * n_l * state.K * 8
    streams = n_folds * (2 * kp + 4 * kp + 128) * 4
    stats = n_folds * state.K * 8 * 2
    return int8_streams + blocks + streams + stats


def _v3_hoist_bytes(state, n_folds, n_l) -> int:
    """The JAX estimate of a hoisted v3 reduce sweep's resident bytes (JAX
    ``core/batch.py:1017``)."""
    kp = _round_up(max(state.K, 8), 128)
    n_sp = ozaki_trim_groups(n_l)
    planes = 2 * n_sp * state.N * kp
    streams = n_folds * (2 * kp + 4 * kp + 128) * 4
    stats = n_folds * state.K * 8 * 2
    return planes + streams + stats


# --------------------------------------------------------------------------- #
# Large-fold routes (fused_ozaki_downdate_df64, fused_epilogue_df64)          #
# --------------------------------------------------------------------------- #


def _reference_vectors(config, state, stats5, like, return_XTX,
                       return_XTY):
    """Reference-form ``kvec`` = [p, i1] and ``cvec`` = [q, i2] of the
    large-fold kernels: p = sw mX and q the means, unscaled; i1, i2 the
    reciprocal stds (1 on an unscaled side)."""
    X_mean, X_std, Y_mean, Y_std, sw = stats5
    f_folds = like.shape[0]
    k = state.K
    m = (state.M or 0) if return_XTY else 0
    c = (k if return_XTX else 0) + m
    center_xtx = config.center_X
    center_xty = config.center_X or config.center_Y
    center = (return_XTX and center_xtx) or (return_XTY and center_xty)
    scale = config.scale_X or (return_XTY and config.scale_Y)

    ones = like.new_ones((f_folds, 1))
    i1 = i2 = p_vec = q_vec = None
    if scale:
        r1 = 1.0 / X_std[:, 0] if config.scale_X else None
        i1 = r1
        i2 = _xy_concat(
            (ones.expand(-1, k) if r1 is None else r1)
            if return_XTX else None,
            (1.0 / Y_std[:, 0] if config.scale_Y else ones.expand(-1, m))
            if return_XTY else None,
        )
    if center:
        mX = X_mean[:, 0]
        p_vec = sw.reshape(-1, 1) * mX
        q_vec = _xy_concat(
            (mX if center_xtx else ones.new_zeros((f_folds, k)))
            if return_XTX else None,
            (Y_mean[:, 0] if center_xty else ones.new_zeros((f_folds, m)))
            if return_XTY else None,
        )
    return _pack_kc_vectors(like, k, c, i1=i1, i2=i2, p_vec=p_vec,
                            q_vec=q_vec)


def _large_fold_path(config, state, rows, mask, *, total, return_XTX,
                     return_XTY, impl="auto", out=None, blocks_stats=None):
    """``(out, stats)`` of large folds in the reference form.

    ``(total - D - sw m1 (x) m2) (.) (r1 (x) r2)`` with ``D = Xv_w^T
    [Xv_u | Yv_u]``: where the JAX large-fold path fuses (one square tile
    of at most 512, at most 1024 rows, exact mode) the Ozaki-df64 kernel
    port gathers the rows and forms D itself, and the statistics come from
    :func:`_summed_stats`; otherwise D is a float64 ``torch.bmm`` of the
    gathered blocks into ``out`` and the epilogue kernel rewrites it in
    place. The JAX path's opt-in SYRK product and its column-blocked
    product for very wide K (a TPU memory workaround) are not ported.
    ``total`` is :func:`_total`'s [XTX | XTY] (or the one requested),
    which a sweep builds once for all its chunks. ``blocks_stats=(blocks,
    stats5)`` takes gathered blocks instead of ``rows``/``mask`` (the mesh
    path): the Ozaki-df64 kernel then gathers the blocks' rows
    (:func:`_block_stream`).
    """
    f_folds, n_l = (rows.shape if blocks_stats is None
                    else blocks_stats[0].Xv_w.shape[:2])
    fused = _use_fused(config, state, return_XTX, return_XTY, n_l)
    if blocks_stats is not None:
        blocks, stats5 = blocks_stats
    elif fused:
        stats5 = _summed_stats(config, state, rows, mask,
                               **_stat_flags(config, return_XTX, return_XTY))
    else:
        blocks, stats5 = _gather_and_stats(config, state, rows, mask,
                                           return_XTX, return_XTY)
    kvec, cvec = _reference_vectors(config, state, stats5,
                                    total.new_empty((f_folds, 0)),
                                    return_XTX, return_XTY)
    if fused:
        if blocks_stats is not None:
            xw, xu, yu, rows = _block_stream(blocks, return_XTY)
            mask = None
        else:
            xw = state.X if state.weights is None else state.WX
            xu, yu = state.X, state.Y if return_XTY else None
        out = _fd.fold_ozaki_df64(total, xw, xu, yu, rows, mask, kvec, cvec,
                                  with_x=return_XTX, impl=impl, out=out)
        return out, stats5[:4]
    m2 = _xy_concat(blocks.Xv_u if return_XTX else None,
                    blocks.Yv_u if return_XTY else None)
    with highest_precision():
        prod = torch.bmm(blocks.Xv_w.mT, m2, out=out)
    return _fd.fold_epilogue(total, prod, kvec, cvec, impl=impl), stats5[:4]


def _f32_kernel_path(config, state, rows, mask, *, total, return_XTX,
                     return_XTY, impl="auto", out=None, blocks_stats=None):
    """``(out, stats)`` of float32 folds of at least ``LARGE_FOLD_ROWS``
    rows: the JAX f32 engine's ``_f32_kernel_path`` (JAX batch.py:1211).

    The gathered blocks ``xv = Xv_w`` (F, L, K) and ``m2 = [Xv_u | Yv_u]``
    (F, L, C) and the statistics, as the JAX path builds them, then the
    port of ``fused_downdate``: ``((total - xv^T m2) - a1 (x) mb) (.)
    (inv1 (x) inv2)`` with ``a1 = sw mX``, ``mb`` the means and ``inv`` the
    reciprocal stds (:func:`_reference_vectors`' ``kvec``/``cvec``).
    ``total`` and ``blocks_stats`` as in :func:`_large_fold_path`.
    """
    blocks, stats5 = blocks_stats or _gather_and_stats(
        config, state, rows, mask, return_XTX, return_XTY)
    kvec, cvec = _reference_vectors(config, state, stats5,
                                    total.new_empty((blocks.Xv_w.shape[0], 0)),
                                    return_XTX, return_XTY)
    m2 = _xy_concat(blocks.Xv_u if return_XTX else None,
                    blocks.Yv_u if return_XTY else None)
    out = _fd.fold_downdate_f32(total, blocks.Xv_w.contiguous(),
                                m2.contiguous(), kvec, cvec, impl=impl,
                                out=out)
    return out, stats5[:4]


# --------------------------------------------------------------------------- #
# Fold plans: a route's operands built once, run a chunk at a time            #
# --------------------------------------------------------------------------- #


class ValidationRows(NamedTuple):
    """A chunk's validation rows on the state's device, as a chunk consumer
    of ``models.sweep.cross_validate_reduce`` gets them: ``X`` (F, L, K) and
    ``Y`` (F, L, M) (``None`` without Y) unweighted, ``w`` (F, L) the rows'
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


def _slice(t, start: int, size: int):
    return None if t is None else t[start:start + size]


def _slice_stats(stats, start: int, size: int):
    return None if stats is None else tuple(_slice(s, start, size)
                                            for s in stats)


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


def _hoist_fits(nbytes: float) -> bool:
    """The reduce sweep's gate on building a route's operands for every
    fold: the policy's ``hoist_reduce`` and the JAX package's budget."""
    return _hoist_reduce_enabled() and nbytes <= _HOIST_BUDGET_BYTES


class _Plan(NamedTuple):
    """A route's operands for a batch of folds, built by :func:`_plan`.

    ``run(c0, size, out=None)`` -> ``(mats, stats)`` of the folds ``c0:c0 +
    size``: ``mats`` as :func:`training_matrices_batched` returns them
    (views of ``out`` where given), ``stats`` their ``(X_mean, X_std,
    Y_mean, Y_std)`` (``None`` where the plan was built without them).
    ``rows(c0, size)`` -> their :class:`ValidationRows` (``None`` on
    gathered blocks)."""

    run: Callable
    rows: Optional[Callable]


def _plan(config, state, route, idx, mask, *, return_XTX, return_XTY, impl,
          with_stats=True, blocks_stats=None, n_rows_total=None, total=None,
          hoist=False) -> Optional[_Plan]:
    """The operands of :func:`route_kernel`'s ``route`` for the (F, L) host
    folds ``idx`` and their ``mask``, built once by the route's builders,
    and how a chunk of them runs: the package's one switch on the route
    after :func:`route_kernel`.

    ``blocks_stats=(blocks, stats5)`` takes gathered blocks and their
    :func:`stats_from_blocks` instead (the mesh path). ``with_stats=False``
    (a materialising sweep) computes no statistic the route does not need.
    ``n_rows_total``: the global row count where ``state`` is one rank's
    row shard (the LOOCV sources). ``total``: the large-fold routes' [XTX |
    XTY], built here where ``None``. ``hoist``: the reduce
    sweep's gate, ``None`` where the JAX package builds no operands for
    every fold (the large-fold routes; the packed and v3 routes off
    ``hoist_reduce`` or over the budget of its memory estimates).
    """
    stats = None
    if route.startswith("loocv"):
        if blocks_stats is None:
            src = prepare_loocv_sources(config, state, idx[:, 0],
                                        return_XTX=return_XTX,
                                        return_XTY=return_XTY,
                                        n_rows_total=n_rows_total)
        else:
            src = loocv_sources_from_blocks(config, state, blocks_stats[0],
                                            return_XTY=return_XTY)
            stats = blocks_stats[1][:4]
        stored = with_stats and stats is None  # by the kernel

        def chunk(c0, size, out):
            # the sources' rows, on the device and checked: no copy, no sync
            res = run_loocv_route(
                config, src, src.rows[c0:c0 + size], route,
                src.scal[c0:c0 + size], return_XTY=return_XTY, impl=impl,
                out=out, return_stats=stored)
            return res if stored else (res, _slice_stats(stats, c0, size))

        def rows_of(c0, size):
            return _validation_rows(state, src.rows[c0:c0 + size], None)
    elif route in ("packed", "packed_f32"):
        if hoist and not _hoist_fits(_hoisted_operand_bytes(
                state, *idx.shape, return_XTX, return_XTY)):
            return None
        ops, stats = prepare_fold_operands(
            config, state, idx, mask, return_XTX=return_XTX,
            return_XTY=return_XTY, blocks_stats=blocks_stats)

        def chunk(c0, size, out):
            return (downdate_from_operands(slice_operands(ops, c0, size),
                                           impl=impl, out=out),
                    _slice_stats(stats, c0, size))
        rows_of = _copied_rows(config, state, idx, mask)
    elif route in ("v3", "v3_sym"):
        if hoist and not _hoist_fits(_v3_hoist_bytes(state, *idx.shape)):
            return None
        if blocks_stats is None:
            src, stats = _ozaki_sources_and_stats(
                config, state, idx, mask, return_XTX, return_XTY,
                with_stats=with_stats)
        else:
            src = ozaki_sources_from_blocks(config, state, *blocks_stats,
                                            return_XTY=return_XTY)
            stats = blocks_stats[1][:4]

        def chunk(c0, size, out):
            return (ozaki_v3_from_sources(config,
                                          slice_operands(src, c0, size),
                                          return_XTY=return_XTY, impl=impl,
                                          out=out),
                    _slice_stats(stats, c0, size))

        def rows_of(c0, size):
            return _validation_rows(state, src.rows[c0:c0 + size],
                                    _slice(src.mask, c0, size))
    else:
        if hoist:
            return None
        large = (_f32_kernel_path if route == "downdate_f32"
                 else _large_fold_path)
        rows = mask_d = None
        if blocks_stats is None:
            with span(SOURCES):
                rows, mask_d = _rows_mask(config, state, idx, mask)
                if total is None:
                    total = _total(state, return_XTX, return_XTY)
        else:
            total = _total(state, return_XTX, return_XTY)

        def chunk(c0, size, out):
            blocks = None if blocks_stats is None else (
                blocks_stats[0]._make(_slice(t, c0, size)
                                      for t in blocks_stats[0]),
                _slice_stats(blocks_stats[1], c0, size))
            return large(config, state, _slice(rows, c0, size),
                         _slice(mask_d, c0, size), total=total,
                         return_XTX=return_XTX, return_XTY=return_XTY,
                         impl=impl, out=out, blocks_stats=blocks)

        def rows_of(c0, size):
            return _validation_rows(state, rows[c0:c0 + size],
                                    _slice(mask_d, c0, size))

    def run(c0, size, out=None):
        mats, chunk_stats = chunk(c0, size, out)
        return _split(mats, state.K, return_XTX, return_XTY), chunk_stats
    return _Plan(run, rows_of if blocks_stats is None else None)


# --------------------------------------------------------------------------- #
# The fold-batch engine                                                       #
# --------------------------------------------------------------------------- #


def _split(out, k: int, return_XTX: bool, return_XTY: bool):
    if return_XTX and return_XTY:
        return out[:, :, :k], out[:, :, k:]
    return out


def training_matrices_batched(
    config: CVConfig,
    state: FitState,
    idx_batch,
    mask_batch=None,
    *,
    return_XTX: bool = True,
    return_XTY: bool = True,
    impl: str = "auto",
    total=None,
):
    """Training matrices for an (F, L) batch of folds (indices in [-N, N),
    the negative ones wrapped) and an optional (F, L) 0/1 mask, on the host
    or the device.

    Returns ``(mats, (X_mean, X_std, Y_mean, Y_std))`` shaped like the
    per-fold engine's batched result: ``mats`` is ``(XTX, XTY)`` of (F, K,
    K) and (F, K, M) or the one requested matrix, statistics (F, 1, K) or
    (F, 1, M) or ``None``. Every batch, float64 or float32, takes the
    kernel route of :func:`route_kernel`, which follows the JAX package's
    gates (its mesh entry ``batched_matrices_from_blocks`` routes the same
    way; its ``training_matrices_batched`` sends one-row folds to the
    packed kernels and v3-sized float64 folds to the Ozaki-df64 kernel
    instead, with the same result). ``impl``: ``"auto"`` (the kernel on
    CUDA, the twin on the CPU), ``"cuda"`` or ``"torch"`` (the twin). The
    JAX package's ``pair_output`` and ``trim_output`` return double-float
    pairs and padded tiles, which the port does not have, so they are not
    ported. ``total``: the state's [XTX | XTY] (or the one requested) for
    the large-fold routes, which otherwise build it on every call; a sweep
    over many batches builds it once and passes it.
    """
    if impl not in _loocv.IMPLS:
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
    mask_np = host_mask(mask_batch)
    route = route_kernel(config, state, idx.shape[1], return_XTX, return_XTY,
                         mask_np is not None, n_folds=idx.shape[0])
    with span(ROUTE + route):
        return _plan(config, state, route, idx, mask_np,
                     return_XTX=return_XTX, return_XTY=return_XTY, impl=impl,
                     total=total).run(0, idx.shape[0])


def batched_matrices_from_blocks(
    config: CVConfig,
    state: FitState,
    blocks: FoldBlocks,
    stats5=None,
    *,
    return_XTX: bool = True,
    return_XTY: bool = True,
    impl: str = "auto",
):
    """Training matrices of batched gathered :class:`FoldBlocks` (JAX
    ``core/batch.py:817``): the mesh path's fold math, with no collective.

    ``state`` supplies the global products and statistics only (the mesh
    path passes a globals-only state; weightedness is read from the
    blocks). Returns ``(mats, (X_mean, X_std, Y_mean, Y_std))`` as
    :func:`training_matrices_batched` does. ``impl="torch"`` runs the
    per-fold engine on the blocks (the JAX ``"xla"``); ``"auto"`` and
    ``"cuda"`` take :func:`route_kernel`'s route, the JAX function's
    gates: the LOOCV kernels with ``rows = arange(F)``
    (:func:`loocv_sources_from_blocks`), the packed kernels on operands
    built from the blocks, the v3 and Ozaki-df64 kernels gathering the
    blocks' rows, the float32 engine's ``fused_downdate`` or a ``bmm`` and
    the epilogue; on CUDA tensors the kernels, on the CPU their twins
    (``"cuda"`` raises there). ``stats5`` is the blocks'
    :func:`stats_from_blocks` where the caller has it.
    """
    if impl not in _loocv.IMPLS:
        raise ValueError(f"Unknown impl: {impl!r} (auto|cuda|torch).")
    if impl == "torch":
        return training_matrices_from_blocks(
            config, state, blocks, return_XTX=return_XTX,
            return_XTY=return_XTY)
    if stats5 is None:
        stats5 = stats_from_blocks(config, state, blocks, return_XTX,
                                   return_XTY)
    f_folds, n_l = blocks.Xv_w.shape[:2]
    route = route_kernel(config, state, n_l, return_XTX, return_XTY,
                         blocks.mask is not None, n_folds=f_folds)
    return _plan(config, state, route, None, None, return_XTX=return_XTX,
                 return_XTY=return_XTY, impl=impl,
                 blocks_stats=(blocks, stats5)).run(0, f_folds)
