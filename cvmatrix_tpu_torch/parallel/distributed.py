"""Multi-device execution on ``torch.distributed``, PyTorch port.

Counterpart of :mod:`cvmatrix_tpu.parallel.distributed`. The JAX layer is
single-controller: one program over a ``Mesh`` of devices. PyTorch's idiom
is one process per device, so this layer is SPMD: every rank of the default
process group calls the same entry points with the same arguments, holds
its own block of rows on its own device, and the ranks meet in
``all_reduce``, ``reduce_scatter`` and ``all_gather`` over a 1-D
:class:`~torch.distributed.device_mesh.DeviceMesh` named ``rows``.

- **Rows** are sharded: :func:`fit_sharded` fits each rank's rows with the
  port's ``fit`` and sums the global products and statistics with one
  ``all_reduce``.
- **Folds** are sharded: validation rows are gathered from the row shards
  by one ``reduce_scatter`` over the fold axis (each rank contributes the
  rows it owns, zeros elsewhere; a sum of one value with exact zeros is
  exact), which hands each rank its own slice of the folds, and the fold
  math runs there through the port's hand-written kernels
  (:func:`~cvmatrix_tpu_torch.core.batch.batched_matrices_from_blocks`).

Both collectives carry float64 on NCCL and gloo, so the JAX layer's split
of 64-bit data into float32 planes has no counterpart, and the port keeps
no compiled programs, so neither do its program caches. Where the group's
backend is gloo and the tensors are on CUDA (two ranks sharing one card),
each collective runs on a host copy: gloo carries CUDA tensors for some
collectives only. A mesh on CUDA launches the kernels or raises; there is
no CPU path when no card is found.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import CVConfig
from ..core import batch as _batch
from ..core.batch import (
    batched_matrices_from_blocks,
    host_folds,
    host_mask,
    stats_from_blocks,
)
from ..core.fit import fit as _fit
from ..core.fold import FoldBlocks
from ..core.state import FitState
from ..models import sweep as _sweep
from ..ops.loocv import IMPLS

__all__ = [
    "ROWS",
    "ShardedFitState",
    "make_mesh",
    "fit_sharded",
    "sharded_training_matrices",
    "sharded_cross_validate_reduce",
]

ROWS = "rows"


def make_mesh(device_type: str = "cuda", axis_name: str = ROWS) -> DeviceMesh:
    """A 1-D mesh named ``rows`` over every rank of the default process
    group (see :func:`cvmatrix_tpu_torch.parallel.multihost.initialize`).

    ``device_type="cuda"`` (the default) puts each rank on the card
    ``LOCAL_RANK`` (else the rank) modulo the cards present, and raises
    without a card; ``"cpu"`` runs on the host (the gloo backend).
    """
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise ValueError(
                "no CUDA card: torch.cuda.is_available() is false. The mesh "
                "runs on the card by default; pass device_type='cpu' to run "
                "on the CPU."
            )
    elif device_type != "cpu":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}.")
    if not dist.is_initialized():
        raise RuntimeError(
            "no default process group: call "
            "cvmatrix_tpu_torch.parallel.multihost.initialize() (or "
            "torch.distributed.init_process_group) first."
        )
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def _group(mesh: DeviceMesh):
    return mesh.get_group(mesh.mesh_dim_names[0])


def _rank_world(mesh: DeviceMesh):
    return mesh.get_local_rank(), mesh.size()


def _device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _staged(mesh: DeviceMesh, t: torch.Tensor) -> bool:
    """Whether a collective on ``t`` runs on a host copy: on a gloo group
    with CUDA tensors (chosen by the backend, not by a failed call)."""
    return (t.device.type == "cuda"
            and dist.get_backend(_group(mesh)) == dist.Backend.GLOO)


def _all_reduce(mesh: DeviceMesh, t: torch.Tensor,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place ``all_reduce`` of ``t`` over the mesh; returns ``t``."""
    if _staged(mesh, t):
        host = t.cpu()
        dist.all_reduce(host, op, group=_group(mesh))
        return t.copy_(host)
    dist.all_reduce(t, op, group=_group(mesh))
    return t


def _reduce_scatter(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks and return this rank's block of its leading
    axis (a multiple of the world size)."""
    rank, world = _rank_world(mesh)
    parts = list((t.cpu() if _staged(mesh, t) else t).contiguous()
                 .chunk(world))
    out = torch.empty_like(parts[rank])
    dist.reduce_scatter(out, parts, group=_group(mesh))
    return out.to(t.device)


def _all_gather(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated along the
    leading axis, in rank order."""
    _, world = _rank_world(mesh)
    src = (t.cpu() if _staged(mesh, t) else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src, group=_group(mesh))
    return torch.cat(parts).to(t.device)


def _tree_map(fn, tree):
    """``fn`` over the tensors of a pytree; ``None`` stays ``None``."""
    return pytree.tree_map(lambda a: None if a is None else fn(a), tree,
                           is_leaf=lambda a: a is None)


# --------------------------------------------------------------------------- #
# Row-sharded fit                                                             #
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ShardedFitState:
    """One rank's part of a row-sharded fit.

    ``local`` is a :class:`~cvmatrix_tpu_torch.core.state.FitState` whose
    data fields hold this rank's block of ``n_rows / world`` rows (padding
    rows at the end carry zero weight) and whose products and statistics
    are the global ones, the same on every rank. ``n_rows`` is the global
    row count after padding to a multiple of the world size and
    ``n_data`` the count before it: fold indices are read in
    ``[-n_data, n_data)``, the negative ones wrapped.
    """

    local: FitState
    n_rows: int
    n_data: int

    @property
    def K(self) -> int:
        return self.local.K

    @property
    def M(self) -> Optional[int]:
        return self.local.M


def _pad_rows(X, Y, weights, n_rows: int, unit_weights: bool):
    """A rank's row block zero-padded to ``n_rows`` rows (JAX ``:68``, per
    rank). Padding rows carry zero weight, which leaves every statistic as
    it was; with ``unit_weights`` unweighted data gets unit weights with
    zero pads (``sum_w = N``, ``nnz = N`` and ``WX = X`` still hold)."""
    if weights is None and unit_weights:
        weights = np.ones((X.shape[0], 1), X.dtype)

    def padded(a):
        if a is None or a.shape[0] == n_rows:
            return a
        return np.concatenate(
            [a, np.zeros((n_rows - a.shape[0], a.shape[1]), a.dtype)])

    return padded(X), padded(Y), padded(weights)


def _as_rows(a, dtype):
    if a is None:
        return None
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a, dtype)
    return a[:, None] if a.ndim == 1 else a


def fit_rank_rows(config: CVConfig, mesh: DeviceMesh, X, Y=None,
                  weights=None, *, n_rows_global: int) -> ShardedFitState:
    """The row-sharded fit from this rank's own rows: the one code path of
    :func:`fit_sharded` and ``multihost.fit_sharded_multihost``.

    ``X`` (and ``Y``, ``weights``) are the rows ``host_row_slice`` assigns
    to this rank, of ``n_rows_global`` rows in all. Each rank pads its
    block to ``ceil(n / world)`` rows (:func:`_pad_rows`: unit weights for
    unweighted data where ``n`` is not a multiple of the world size), fits
    it on its device and sums the products and statistics over the mesh.
    Negative weights raise on every rank or on none: the verdict is summed
    over the mesh before any other collective, so a bad row on one rank
    cannot leave the others waiting.
    """
    rank, world = _rank_world(mesh)
    dt = np.dtype(config.dtype)
    X, Y, weights = _as_rows(X, dt), _as_rows(Y, dt), _as_rows(weights, dt)
    per = -(-n_rows_global // world)
    start = min(rank * per, n_rows_global)
    stop = min((rank + 1) * per, n_rows_global)
    if X.shape[0] != stop - start:
        raise ValueError(f"rank {rank} holds {X.shape[0]} rows; it owns "
                         f"{stop - start} (load per host_row_slice()).")
    device = _device(mesh)
    bad = torch.tensor([int(weights is not None and bool((weights < 0).any()))],
                       device=device)
    if _all_reduce(mesh, bad).item():
        raise ValueError("Weights must be non-negative.")
    X, Y, weights = _pad_rows(X, Y, weights, per,
                              per * world != n_rows_global)
    local = _fit(config, X, Y, weights, validate=False, device=device)
    names = [f for f in ("XTX", "XTY", "sum_X", "sum_Y", "sum_sq_X",
                         "sum_sq_Y", "sum_w")
             if getattr(local, f) is not None]
    parts = [getattr(local, f) for f in names]
    flat = _all_reduce(mesh, torch.cat([p.reshape(-1) for p in parts]))
    summed, off = {}, 0
    for name, p in zip(names, parts):
        summed[name] = flat[off:off + p.numel()].reshape(p.shape)
        off += p.numel()
    if local.num_nonzero_w is not None:
        summed["num_nonzero_w"] = _all_reduce(mesh,
                                              local.num_nonzero_w.clone())
    return ShardedFitState(dataclasses.replace(local, **summed),
                           n_rows=per * world, n_data=n_rows_global)


def fit_sharded(config: CVConfig, mesh: DeviceMesh, X, Y=None,
                weights=None) -> ShardedFitState:
    """Row-sharded fit (JAX ``:90``): every rank passes the full host
    arrays, keeps its block of rows on its device and sums the partial
    products and statistics over the mesh (:func:`fit_rank_rows`).

    The returned state holds this rank's rows, the global products and
    statistics, and the global padded row count; weights that are
    negative anywhere raise ``ValueError`` on every rank.
    """
    X = _as_rows(X, np.dtype(config.dtype))
    rank, world = _rank_world(mesh)
    n = X.shape[0]
    per = -(-n // world)
    rows = slice(min(rank * per, n), min((rank + 1) * per, n))

    def mine(a):
        return None if a is None else _as_rows(a, np.dtype(config.dtype))[rows]

    return fit_rank_rows(config, mesh, X[rows], mine(Y), mine(weights),
                         n_rows_global=n)


# --------------------------------------------------------------------------- #
# Gathers                                                                     #
# --------------------------------------------------------------------------- #


def _gather_sources(config: CVConfig, state: FitState, return_XTY: bool):
    """The row streams the gathers read (JAX ``:171``): ``X`` and ``w``,
    not the weighted planes, which are formed again after the collective
    (``WX[i] = w[i] X[i]`` row by row, so bit for bit the fit's) at half
    the bytes; the ``WX`` stream alone where the data are unweighted."""
    sources = ({"WX": state.WX} if state.weights is None
               else {"X": state.X, "w": state.weights})
    if return_XTY:
        sources["Y"] = state.Y
    return sources


def _local_gather_scatter(mesh: DeviceMesh, sources: dict,
                          idx: np.ndarray) -> dict:
    """Fold-sharded row gather (JAX ``:214``): ``idx`` (F, L) global rows,
    F a multiple of the world size, on the host.

    Each rank contributes the rows it owns and zeros elsewhere, for every
    fold, as one stream (every source side by side), and one
    ``reduce_scatter`` over the fold axis hands each rank the summed
    blocks of its own ``F / world`` folds. At world size 1 the gather is
    the plain index.
    """
    rank, world = _rank_world(mesh)
    first = next(iter(sources.values()))
    device = first.device
    if world == 1:
        rows = torch.from_numpy(idx).to(device)
        return {k: a[rows] for k, a in sources.items()}
    shard_rows = first.shape[0]
    li = idx - rank * shard_rows
    mine = torch.from_numpy((li >= 0) & (li < shard_rows)).to(device)
    rows = torch.from_numpy(np.clip(li, 0, shard_rows - 1)).to(device)
    stacked = torch.cat([a[rows] for a in sources.values()], dim=-1)
    fused = _reduce_scatter(mesh, stacked.masked_fill_(~mine[..., None], 0))
    out, off = {}, 0
    for k, a in sources.items():
        out[k] = fused[..., off:off + a.shape[1]].contiguous()
        off += a.shape[1]
    return out


def _blocks_from_gathered(config: CVConfig, weighted: bool, gathered: dict,
                          mask, return_XTY: bool) -> FoldBlocks:
    """The gathered streams as :class:`FoldBlocks`, by ``gather_val_blocks``'
    aliasing and masking rules (JAX ``:266``)."""
    gX, gY, gw = gathered.get("X"), gathered.get("Y"), gathered.get("w")
    if weighted:
        gWX = gX * gw
        gWY = None if gY is None or not config.needs_WY else gY * gw
    else:
        gWX, gWY = gathered["WX"], None
    Xv_u = gX if weighted else gWX
    Xv_w = gWX if mask is None else gWX * mask[..., None]
    Yv_w = Yv_u = None
    if return_XTY:
        Yv_u = gY
        Yv_raw = gWY if (weighted and config.needs_WY) else gY
        Yv_w = Yv_raw if mask is None else Yv_raw * mask[..., None]
    w_val = None
    if gw is not None:
        w_val = gw if mask is None else gw * mask[..., None]
    return FoldBlocks(Xv_w, Xv_u, Yv_w, Yv_u, w_val, mask)


def _globals_only(config: CVConfig, state: ShardedFitState) -> FitState:
    """The replicated globals alone (JAX ``:336``): the fold math reads the
    gathered blocks, never the data fields, which become (1, K) and (1, M)
    zeros so that K and M stay readable."""
    loc = state.local
    zeros = loc.XTX.new_zeros((1, loc.K))
    return dataclasses.replace(
        loc, X=zeros, WX=zeros, WY=None, weights=None,
        Y=None if loc.Y is None else loc.XTX.new_zeros((1, loc.M)))


def _check_entry(config: CVConfig, state: ShardedFitState, mesh: DeviceMesh,
                 impl: str, return_XTX: bool, return_XTY: bool) -> None:
    """The port's ``impl`` check (JAX ``_resolve_mesh_impl``, ``:323``) and
    the argument checks every mesh entry shares."""
    if impl not in IMPLS:
        raise ValueError(f"Unknown impl: {impl!r} (auto|cuda|torch).")
    if impl == "cuda" and mesh.device_type != "cuda":
        raise ValueError(f"impl='cuda' needs a CUDA mesh; the mesh is on "
                         f"{mesh.device_type}.")
    if not return_XTX and not return_XTY:
        raise ValueError(
            "At least one of `return_XTX` and `return_XTY` must be True."
        )
    if return_XTY and state.M is None:
        raise ValueError("Response variables `Y` are not provided.")


def _device_mask(config: CVConfig, mask, device):
    return None if mask is None else torch.as_tensor(
        mask, dtype=config.torch_dtype, device=device).contiguous()


def _fold_blocks(config, state, mesh, idx, mask, return_XTY):
    """Gather the folds ``idx`` (F, L) and mask (F, L) and return this
    rank's :class:`FoldBlocks`: folds ``[rank F / world, (rank + 1) F /
    world)``."""
    rank, world = _rank_world(mesh)
    f_loc = idx.shape[0] // world
    gathered = _local_gather_scatter(
        mesh, _gather_sources(config, state.local, return_XTY), idx)
    my_mask = None if mask is None else mask[rank * f_loc:(rank + 1) * f_loc]
    return _blocks_from_gathered(
        config, state.local.weights is not None, gathered,
        _device_mask(config, my_mask, state.local.device), return_XTY)


# --------------------------------------------------------------------------- #
# Entry points                                                                #
# --------------------------------------------------------------------------- #


def sharded_training_matrices(
    config: CVConfig,
    state: ShardedFitState,
    idx_batch,
    mask_batch=None,
    *,
    mesh: DeviceMesh,
    return_XTX: bool = True,
    return_XTY: bool = True,
    trim_padding: bool = True,
    impl: str = "auto",
):
    """Every fold's training matrices on the mesh (JAX ``:361``): gather,
    then fold-sharded math.

    ``idx_batch`` (F, L) are the folds' rows in ``[-n_data, n_data)``
    (negatives wrapped), ``mask_batch`` an optional (F, L) 0/1 mask; every
    rank passes the same. The fold axis is padded to a multiple of the
    world size by repeating the last fold. This rank computes its slice of
    the padded folds through :func:`~cvmatrix_tpu_torch.core.batch.
    batched_matrices_from_blocks` (``impl`` as there: ``"auto"`` the
    kernels on a CUDA mesh and their twins on a CPU mesh, ``"cuda"`` the
    kernels or a raise, ``"torch"`` the per-fold engine).

    ``trim_padding=True`` returns ``(mats, stats)`` of every fold on every
    rank (gathered over the mesh, the padding dropped), as the JAX
    function's global array. ``trim_padding=False`` returns ``((mats,
    stats), n_folds)`` with this rank's slice only: the global folds
    ``[rank * P / world, (rank + 1) * P / world)`` of the P padded ones,
    whose entries from ``n_folds`` on repeat the last fold.
    """
    _check_entry(config, state, mesh, impl, return_XTX, return_XTY)
    _, world = _rank_world(mesh)
    idx = host_folds(idx_batch, state.n_data)
    mask = host_mask(mask_batch)
    n_folds = idx.shape[0]
    idx, mask = _sweep._pad_folds(idx, mask, world)
    blocks = _fold_blocks(config, state, mesh, idx, mask, return_XTY)
    out = batched_matrices_from_blocks(
        config, _globals_only(config, state), blocks,
        return_XTX=return_XTX, return_XTY=return_XTY, impl=impl)
    if not trim_padding:
        return out, n_folds
    return _tree_map(lambda a: _all_gather(mesh, a)[:n_folds], out)


def _default_batch(state, n_l, world, return_XTX, return_XTY,
                   hbm_budget_bytes):
    """Folds a chunk, all ranks together (JAX ``:523-533``): a per-device
    budget of the output pairs plus the gathered streams a fold."""
    k = state.K
    c = (k if return_XTX else 0) + ((state.M or 0) if return_XTY else 0)
    per_fold = 2 * 8 * max(k * c, 1)
    per_fold += 4 * 8 * n_l * (k + (state.M or 0) + 1)
    return world * max(1, min(2000, int(hbm_budget_bytes / per_fold)))


def sharded_cross_validate_reduce(
    config: CVConfig,
    state: ShardedFitState,
    idx_batch,
    mask_batch=None,
    *,
    mesh: DeviceMesh,
    reduce_fn,
    batch_size: Optional[int] = None,
    return_XTX: bool = True,
    return_XTY: bool = True,
    impl: str = "auto",
    hbm_budget_bytes: float = 4e9,
):
    """Mesh counterpart of :func:`~cvmatrix_tpu_torch.models.sweep.
    cross_validate_reduce` (JAX ``:482``): map ``reduce_fn(mats, stats)``
    over every fold's training matrices, each rank over its own folds;
    returns the reductions of all P folds, in the caller's order, on every
    rank. Arguments as in :func:`sharded_training_matrices`;
    ``batch_size`` is the folds of a chunk over all ranks (default: the
    JAX layer's per-device budget).

    The JAX layer's gates, in its order, for ``impl`` ``"auto"`` or
    ``"cuda"`` (``"torch"`` takes the generic body with the per-fold
    engine, the JAX ``"xla"``):

    1. LOOCV in natural order (``idx[i] == [i]``, at least half the padded
       rows, unmasked, one tile): every rank already holds the validation
       rows of its folds, so no rows move; each rank builds the LOOCV fold
       plan of its rows once, with the global row count, and runs the
       sweep's chunk loop on it.
    2. Folds under the small-fold threshold (the packed route, one-row
       folds included): one gather for the whole fold list, then the packed
       fold plan once and the sweep's chunk loop on this rank's folds.
    3. v3-sized float64 folds: the same with the v3 route.
    4. Otherwise chunks of equal size, a multiple of the world size: a
       gather, :func:`~cvmatrix_tpu_torch.core.batch.
       batched_matrices_from_blocks` and the reduction per chunk.

    The hoisted paths honour the policy's ``hoist_reduce`` and the JAX
    memory estimates, so both packages take the same path for the same
    world size.
    """
    _check_entry(config, state, mesh, impl, return_XTX, return_XTY)
    _, n_dev = _rank_world(mesh)
    idx = host_folds(idx_batch, state.n_data)
    mask = host_mask(mask_batch)
    n_folds, n_l = idx.shape
    g = _globals_only(config, state)
    if batch_size is None:
        batch_size = _default_batch(g, n_l, n_dev, return_XTX, return_XTY,
                                    hbm_budget_bytes)
    is_f64 = np.dtype(config.dtype).itemsize == 8
    kernels = (impl != "torch" and np.dtype(config.dtype).itemsize in (4, 8)
               and state.n_rows % n_dev == 0)
    if (kernels and mask is None and n_l == 1 and return_XTX
            and _batch.loocv_single_tile_ok(config, g, return_XTX,
                                            return_XTY)
            and n_folds <= state.n_rows <= 2 * n_folds
            and np.array_equal(idx[:, 0], np.arange(n_folds))):
        return _sharded_loocv_identity_reduce(
            config, state, mesh, reduce_fn, batch_size // n_dev, n_folds,
            return_XTY=return_XTY, impl=impl)
    if kernels and _batch._hoist_reduce_enabled():
        threshold = (_batch.large_fold_threshold(config, g, return_XTX,
                                                 return_XTY)
                     if is_f64 else _batch.LARGE_FOLD_ROWS)
        f_dev = -(-n_folds // n_dev)
        if n_l < threshold and _batch._hoisted_operand_bytes(
                g, f_dev, n_l, return_XTX, return_XTY
        ) <= _batch._HOIST_BUDGET_BYTES:
            # one-row folds too: the JAX layer sends them to packed here
            return _sharded_hoisted_reduce(
                config, state, mesh, idx, mask, reduce_fn,
                batch_size // n_dev, "packed" if is_f64 else "packed_f32",
                return_XTX=return_XTX, return_XTY=return_XTY, impl=impl)
        if (n_l >= threshold and is_f64 and return_XTX
                and _batch.ozaki_v3_ok(config, g, return_XTX, return_XTY, n_l)
                and _batch._v3_blocks_hoist_bytes(g, f_dev, n_l)
                <= _batch._HOIST_BUDGET_BYTES):
            return _sharded_hoisted_reduce(
                config, state, mesh, idx, mask, reduce_fn,
                batch_size // n_dev,
                _batch.route_kernel(config, g, n_l, return_XTX, return_XTY,
                                    mask is not None),
                return_XTX=return_XTX, return_XTY=return_XTY, impl=impl)
    # Generic body: chunks equalised, each a multiple of the world size.
    bs = max(n_dev, min(batch_size, n_folds) // n_dev * n_dev)
    n_chunks = -(-n_folds // bs)
    bs = -(-(-(-n_folds // n_chunks)) // n_dev) * n_dev
    n_chunks = -(-n_folds // bs)
    idx, mask = _sweep._pad_folds(idx, mask, bs)
    out = []
    for c0 in range(0, n_chunks * bs, bs):
        blocks = _fold_blocks(config, state, mesh, idx[c0:c0 + bs],
                              None if mask is None else mask[c0:c0 + bs],
                              return_XTY)
        mats, stats = batched_matrices_from_blocks(
            config, g, blocks, return_XTX=return_XTX, return_XTY=return_XTY,
            impl=impl)
        out.append(_sweep._vmap_reduce(reduce_fn, mats, stats))

    def assemble(a):  # (ranks, chunks, bs / ranks, ...) -> fold order
        a = _all_gather(mesh, a).reshape(n_dev, n_chunks, bs // n_dev,
                                         *a.shape[1:])
        return a.transpose(0, 1).reshape(-1, *a.shape[3:])[:n_folds]

    return _tree_map(assemble, _sweep._stack_chunks(out))


def _sharded_loocv_identity_reduce(config, state, mesh, reduce_fn,
                                   bs_local_target, n_folds, *, return_XTY,
                                   impl):
    """LOOCV in natural order with no rows moved (JAX ``:737``).

    Rank ``d`` holds rows ``[d R, (d + 1) R)``, which are the validation
    rows of folds ``[d R, (d + 1) R)``: it builds the LOOCV fold plan of
    its rows with the global row count (``core.batch``: the sources once)
    and runs the sweep's chunk loop on it (per chunk the kernel, the
    statistics and the reduction, the last chunk a tail), and the
    reductions are gathered in rank order, the folds'.
    """
    local = state.local
    R = local.N
    bs_local = max(1, min(bs_local_target, R))
    route = _batch.route_kernel(config, local, 1, True, return_XTY, False,
                                n_folds=bs_local)
    plan = _batch._plan(config, local, route, np.arange(R)[:, None], None,
                        return_XTX=True, return_XTY=return_XTY, impl=impl,
                        n_rows_total=state.n_rows)
    chunks = _sweep._run_chunks(plan, R, bs_local,
                                _sweep._reducer(reduce_fn))
    return _tree_map(lambda a: _all_gather(mesh, a)[:n_folds],
                     _sweep._stack_chunks(chunks))


def _sharded_hoisted_reduce(config, state, mesh, idx, mask, reduce_fn,
                            bs_local_target, route, *, return_XTX,
                            return_XTY, impl):
    """Hoisted reduce sweep over gathered blocks (JAX ``:900``) of the
    packed or v3 ``route``.

    Rank ``d`` owns folds ``[d F_loc, (d + 1) F_loc)``. One gather for the
    whole fold list delivers each rank its folds' rows; the statistics and
    the route's fold plan are built once from them (``core.batch``), and
    the sweep's chunk loop runs it over this rank's folds in equal chunks.
    The reductions are gathered in rank order, the folds'.
    """
    _, n_dev = _rank_world(mesh)
    n_folds = idx.shape[0]
    bs_local, n_chunks = _sweep.chunking(-(-n_folds // n_dev), state.K, 0,
                                         max(1, bs_local_target))
    f_loc = n_chunks * bs_local
    idx, mask = _sweep._pad_folds(idx, mask, n_dev * f_loc)
    g = _globals_only(config, state)
    blocks = _fold_blocks(config, state, mesh, idx, mask, return_XTY)
    plan = _batch._plan(
        config, g, route, None, None, return_XTX=return_XTX,
        return_XTY=return_XTY, impl=impl, blocks_stats=(
            blocks, stats_from_blocks(config, g, blocks, return_XTX,
                                      return_XTY)))
    chunks = _sweep._run_chunks(plan, f_loc, bs_local,
                                _sweep._reducer(reduce_fn))
    return _tree_map(lambda a: _all_gather(mesh, a)[:n_folds],
                     _sweep._stack_chunks(chunks))
