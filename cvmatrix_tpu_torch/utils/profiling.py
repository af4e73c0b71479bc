"""Profiling helpers of the PyTorch port: a profiler trace, a completion
fence and a timer with a byte counter.

Counterpart of :mod:`cvmatrix_tpu.utils.profiling`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
import torch.utils._pytree as pytree

__all__ = ["trace", "device_fence", "Stopwatch"]


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
