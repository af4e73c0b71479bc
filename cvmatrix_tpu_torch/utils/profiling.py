"""Profiling helpers of the PyTorch port: a profiler trace, a completion
fence, a timer with a byte counter, and the program's spans.

Counterpart of :mod:`cvmatrix_tpu.utils.profiling`; the spans are the
port's own.

The port opens its spans through :func:`span` (and :func:`spanned`,
:func:`to_device`, built on it) at its layer boundaries. Each is a
``torch.profiler.record_function`` range, so it lands in the profiler's
Chrome trace beside the card's kernels and copies, on the profiler's clock:
:func:`trace` records them. With no profiler recording, a span costs one
check and enters nothing (0.4-0.8 us a span on a CPU build of torch 2.13,
against 9-13 us for a ``record_function`` entered regardless). The spans, by
name:

- ``cvmatrix_tpu_torch.core.fit``: each ``core.fit.fit`` call;
- ``cvmatrix_tpu_torch.core.batch.route.<route>``: each
  ``core.batch.training_matrices_batched`` call, from the moment
  ``route_kernel`` has chosen ``<route>`` (a key of ``TPU_KERNELS``): one a
  chunk, so their counts by name are the chunks by route;
- ``cvmatrix_tpu_torch.core.batch.sources``: ``prepare_loocv_sources``,
  ``prepare_ozaki_sources``, ``prepare_fold_operands``, and on the
  large-fold routes the rows, mask and ``[XTX | XTY]`` built for a call or
  a sweep;
- ``cvmatrix_tpu_torch.core.batch.stats``: the folds' training statistics,
  ``_summed_stats`` and ``stats_from_blocks`` (none on the LOOCV routes,
  whose kernel stores the statistics);
- ``cvmatrix_tpu_torch.h2d``: each copy of fold rows or a fold mask from
  the host to the state's device (:func:`to_device`): on a card a pin and
  a non-blocking copy, which waits for no stream;
- ``cvmatrix_tpu_torch.models.sweep.<entry>``: each
  ``cross_validate_reduce`` and ``materialize_sweep`` call;
- ``cvmatrix_tpu_torch.models.sweep.reduce_fn``: the user's reduction over
  one chunk (``torch.func.vmap``), with the copies of views it returns.
- ``cvmatrix_tpu_torch.models.pls.<entry>``: each ``cross_validate_pls``
  call;
- ``cvmatrix_tpu_torch.models.pls.route.<route>``: inside it, the bucket's
  sweep from the moment ``models.pls.operator_route`` has chosen
  ``<route>``: ``operator``, ``wide_op`` (no fold matrix formed) or
  ``formed`` (the reduce sweep on formed fold matrices); one a call;
- ``cvmatrix_tpu_torch.models.pls.solve``: one chunk's IKPLS #2 solve and
  score (``models.pls.solve``: the ``ikpls2`` or ``ikpls2_wide`` kernels or
  their twin, on formed fold matrices; ``models.pls.solve_operator``:
  ``ikpls2_op`` or its twin, on leave-one-out folds with none formed;
  ``models.pls.solve_wide_operator``: the ``ikpls2_wide_op`` kernels or
  their twin, on wide folds with none formed);
- ``cvmatrix_tpu_torch.ops.pls.ikpls2_wide``: inside it, each solve of the
  wide route on formed fold matrices (``ops.pls.ikpls2_wide``: wider than
  ``ops.pls.MAX_K``), kernels or twin;
- ``cvmatrix_tpu_torch.ops.pls.ikpls2_wide_op``: inside it, each solve of
  the wide route with no fold matrix formed (``ops.pls.ikpls2_wide_op``:
  float64 buckets wider than ``ops.pls.MAX_K`` under ``impl`` "auto" or
  "cuda"), kernels or twin.

No span nests inside another of its name, and none changes a result. The
fold-components that the solves solve (F x A a chunk) are counted by route
by ``ops.pls.fold_components(route)``, and the copies :func:`to_device`
makes by kind by :func:`h2d_counts`.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Iterator, Optional

import torch
import torch.utils._pytree as pytree

__all__ = ["trace", "device_fence", "Stopwatch", "span", "spanned",
           "to_device", "h2d_counts", "reset_h2d_counts"]

PREFIX = "cvmatrix_tpu_torch."
FIT = PREFIX + "core.fit"
ROUTE = PREFIX + "core.batch.route."
SOURCES = PREFIX + "core.batch.sources"
STATS = PREFIX + "core.batch.stats"
H2D = PREFIX + "h2d"
SWEEP = PREFIX + "models.sweep."
REDUCE_FN = SWEEP + "reduce_fn"
PLS = PREFIX + "models.pls."
PLS_SOLVE = PLS + "solve"
PLS_ROUTE = PLS + "route."
PLS_WIDE = PREFIX + "ops.pls.ikpls2_wide"
PLS_WIDE_OP = PREFIX + "ops.pls.ikpls2_wide_op"

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function(name)`` range while a profiler
    records, else a shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: each call of the function runs in :func:`span` ``(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def to_device(t: torch.Tensor, device, *, copy: bool = False
              ) -> torch.Tensor:
    """``t`` on ``device``, in an ``h2d`` span where ``t`` is on the host:
    the port moves fold rows and masks to the state's device through it.

    A host tensor bound for a card is copied into pinned host memory, then
    to the card without blocking: the host waits for no stream, the caching
    host allocator holds the pinned block until the copy has run, and a
    later write to ``t`` cannot reach what was copied (``copy`` is implied).
    Elsewhere it is ``t.to(device, copy=copy)``. Every call on a host tensor
    counts one copy in :func:`h2d_counts`, as ``"non_blocking"``: the host
    waits for no device.
    """
    if not t.is_cpu:
        return t.to(device, copy=copy)
    _H2D_COUNTS["non_blocking"] += 1
    with span(H2D):
        if torch.device(device).type == "cpu":
            return t.to(device, copy=copy)
        # not t.pin_memory(): that returns a pinned t itself, uncopied
        pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return pinned.copy_(t).to(device, non_blocking=True)


_H2D_COUNTS = {"blocking": 0, "non_blocking": 0}


def h2d_counts() -> dict:
    """``{kind: copies}`` of the host tensors :func:`to_device` has copied
    since :func:`reset_h2d_counts` (or the import): ``"non_blocking"``, and
    ``"blocking"``, a copy after which the host waits for the device's
    stream, of which the port makes none (the tests hold it at 0)."""
    return dict(_H2D_COUNTS)


def reset_h2d_counts() -> None:
    for kind in _H2D_COUNTS:
        _H2D_COUNTS[kind] = 0


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` (the CPU, and the card
    where there is one) and write a Chrome trace
    (``trace_<pid>_<ns>.json``) to ``logdir``; yields the profiler, whose
    ``key_averages()`` sum the block's time by kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def device_fence(tree) -> float:
    """Wait for every device that holds a tensor of ``tree``; returns the
    probe the JAX function returns: one element of each tensor leaf (its
    first), summed in float32 in leaf order, as a float."""
    leaves = [x for x in pytree.tree_leaves(tree)
              if isinstance(x, torch.Tensor)]
    for dev in {x.device for x in leaves if x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    s = torch.zeros((), dtype=torch.float32)
    for x in leaves:
        first = x[(0,) * x.ndim] if x.ndim else x
        s = first.to(device="cpu", dtype=torch.float32) + s
    return float(s)


class Stopwatch:
    """Wall-clock timer with an optional byte counter -> achieved GB/s.

    On a CUDA device (``device``, or by default the current card once CUDA
    is initialised) it synchronises the card before starting and before
    stopping, so the time covers the device work queued inside the block.
    """

    def __init__(self, bytes_accessed: Optional[int] = None,
                 device=None) -> None:
        self.bytes_accessed = bytes_accessed
        self.elapsed: Optional[float] = None
        if device is None:
            self._cuda = torch.cuda.is_initialized()
        else:
            self._cuda = torch.device(device).type == "cuda"
        self._device = device

    def _sync(self) -> None:
        if self._cuda:
            torch.cuda.synchronize(self._device)

    def __enter__(self) -> "Stopwatch":
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._sync()
        self.elapsed = time.perf_counter() - self._t0

    @property
    def gbps(self) -> Optional[float]:
        if self.bytes_accessed is None or not self.elapsed:
            return None
        return self.bytes_accessed / self.elapsed / 1e9
