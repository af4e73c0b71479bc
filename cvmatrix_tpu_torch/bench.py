"""Headline benchmark of the PyTorch port: weighted all-on LOOCV on the
reference grid, total cross-validation time as folds/s.

Counterpart of the repository's ``bench.py``, step by step: N=100,000
samples, K=500 features, M=10 targets, float64, random nonuniform weights,
all four centre/scale flags on, P=100,000-fold (leave-one-out)
cross-validation. The measured quantity is the reference's: total
cross-validation time = one fit + the training matrices of ALL folds, warm
(the kernels built and loaded first). ``vs_baseline`` is folds/s over the
fastest published reference number for this configuration, 1.299 s on an
RTX 3090 Ti (BASELINE.md), about 76,982 folds/s.

Run it as ``python3 bench_torch.py`` from the root of a checkout. It prints
ONE JSON line to stdout (``bench.py``'s keys, plus ``package`` and the
card's name and power limit, ``card``) and its log to stderr. Environment
knobs, as in ``bench.py``:

  BENCH_N (100000)  BENCH_K (500)  BENCH_M (10)  BENCH_P (N: LOOCV)
  BENCH_DTYPE ("float64" | "float32")
  BENCH_BATCH (0 = the sweep's 4 GB chunk rule) folds a chunk
  BENCH_PHASES ("1") warm fit and folds (they pay the kernel build), then
             the fit and the folds timed apart, before the total
  BENCH_DEVICE_TIMEOUT (900) seconds the card may take to come up

Where it differs from ``bench.py``:

  BENCH_PLATFORM  unset: the CUDA card, which must be there (no fallback);
                  "cpu": the host, through the kernels' plain twins.
  BENCH_IMPL      the port's ``auto | cuda | torch``
                  (:data:`cvmatrix_tpu_torch.ops.loocv.IMPLS`); the JAX
                  names ``pallas`` and ``xla`` raise.
  BENCH_AOT, BENCH_PERSISTENT_CACHE  not read. The port's compiled programs
                  are its kernel libraries, which do not depend on the
                  shape: the build cache keeps each one under
                  ``.cache/cvmatrix_tpu_torch`` (ignored by git), keyed by
                  source, flags and ``nvcc`` version, so a later run of the
                  checkout loads them and builds nothing.
                  ``CVMATRIX_TPU_TORCH_CACHE`` names another build
                  directory (``utils.enable_persistent_cache``);
                  ``utils.aot`` ships the libraries to a host without
                  ``nvcc``.

The measurement is the reference grid's ``warmjit`` row
(:func:`cvmatrix_tpu_torch.benchmarks.grid.run_row`), whose order is
``bench.py``'s: warm phases, the total's first call, the timed total. Every measurement ends with the card's synchronisation and
a host fetch of the probe. With one fold size the total is one
``materialize_cv``; with several, one fit and one ``materialize_sweep`` a
size, the probes summed on the device and fetched once.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from typing import Callable, Optional

import numpy as np
import torch

BASELINE_FOLDS_PER_SEC = 100_000 / 1.299  # reference, RTX 3090 Ti, warm JIT
PACKAGE = "cvmatrix_tpu_torch"
# The JAX entry's BENCH_IMPL names and the port's counterparts.
JAX_IMPLS = {"pallas": "cuda", "xla": "torch"}


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def metric_name(N: int, K: int, P: int, dtype) -> str:
    """``bench.py``'s metric name, letter for letter."""
    return (f"weighted_TTTT_P{P}_total_cv_folds_per_sec_"
            f"n{N}_k{K}_{np.dtype(dtype).name}")


def check_impl(impl: str) -> str:
    """``BENCH_IMPL``: one of the port's names, or ``ValueError``."""
    from .ops.loocv import IMPLS

    if impl in JAX_IMPLS:
        raise ValueError(
            f"BENCH_IMPL={impl!r} names the JAX package's route; the port's "
            f"are {'|'.join(IMPLS)} (its counterpart of {impl!r} is "
            f"{JAX_IMPLS[impl]!r}).")
    if impl not in IMPLS:
        raise ValueError(f"BENCH_IMPL={impl!r}: expected one of "
                         f"{'|'.join(IMPLS)}.")
    return impl


def _backend_watchdog(seconds: float) -> threading.Event:
    """Fail fast (one JSON line on stdout, exit code 3) if the device does
    not come up within ``seconds``; set the returned event to disarm it."""
    ready = threading.Event()

    def bail():
        if not ready.wait(seconds):
            print(json.dumps({
                "metric": "benchmark_backend_unavailable",
                "value": 0.0,
                "unit": "folds/s",
                "vs_baseline": 0.0,
                "package": PACKAGE,
            }), flush=True)
            log(f"device did not initialise within {seconds:.0f}s — aborting")
            os._exit(3)

    threading.Thread(target=bail, daemon=True).start()
    return ready


def init_device(platform: Optional[str]) -> torch.device:
    """``BENCH_PLATFORM``'s device, brought up: on the card CUDA is
    initialised and a first tensor allocated there."""
    from .benchmarks.grid import bench_device

    device = bench_device(platform)
    if device.type == "cuda":
        torch.cuda.init()
    torch.zeros(1, device=device)
    return device


def bench_data(N: int, K: int, M: int, dtype):
    """``bench.py``'s data: X, then Y, then the weights from
    ``default_rng(42)``, drawn in float64 and cast to ``dtype``."""
    rng = np.random.default_rng(42)
    X = rng.random((N, K), dtype=np.float64).astype(dtype)
    Y = rng.random((N, M), dtype=np.float64).astype(dtype)
    return X, Y, rng.random(N).astype(dtype)


def run(N: int = 100_000, K: int = 500, M: int = 10,
        P: Optional[int] = None, dtype=np.float64, *,
        batch: Optional[int] = None, impl: str = "auto", phases: bool = True,
        device="cuda", say: Callable[..., None] = log):
    """The bench on ``device`` (``P`` defaults to ``N``: LOOCV): the data
    made here (not timed), then the grid's ``warmjit`` row of them; returns
    that
    :class:`~cvmatrix_tpu_torch.benchmarks.grid.Row`. ``say`` gets the log
    lines."""
    from .benchmarks.grid import run_row

    impl = check_impl(impl)
    P = N if P is None else P
    device = torch.device(device)
    X, Y, weights = bench_data(N, K, M, dtype)
    Xd, Yd, wd = (torch.from_numpy(a).to(device) for a in (X, Y, weights))
    del X, Y, weights
    row = run_row((True,) * 4, P, Xd, Yd, wd, batch, "warmjit", device,
                  impl=impl, phases=phases)
    if phases:
        say(f"warm-up fit and folds (kernel build or load): "
            f"{row.t_warmup:.3f}s")
        say(f"warm phases: fit={row.t_fit:.3f}s folds={row.t_folds:.3f}s")
    say(f"total-CV first call: {row.t_first:.3f}s")
    say(f"warm total CV (single barrier): {row.total:.3f}s "
        f"-> {P / row.total:,.0f} folds/s")
    return row


def main() -> None:
    from .benchmarks.grid import card_line
    from .utils import enable_persistent_cache

    N = int(os.environ.get("BENCH_N", 100_000))
    K = int(os.environ.get("BENCH_K", 500))
    M = int(os.environ.get("BENCH_M", 10))
    P = int(os.environ.get("BENCH_P", N))  # LOOCV by default
    dtype = np.dtype(os.environ.get("BENCH_DTYPE", "float64")).type
    batch = int(os.environ.get("BENCH_BATCH", 0)) or None  # None: 4 GB rule
    impl = check_impl(os.environ.get("BENCH_IMPL", "auto"))
    phases = os.environ.get("BENCH_PHASES", "1") != "0"

    ready = _backend_watchdog(
        float(os.environ.get("BENCH_DEVICE_TIMEOUT", 900)))
    try:
        device = init_device(os.environ.get("BENCH_PLATFORM"))
    finally:
        ready.set()  # the device is up, or raised: disarm the watchdog
    card = card_line(device)

    if os.environ.get("CVMATRIX_TPU_TORCH_CACHE"):
        log(f"kernel build cache: {enable_persistent_cache()}")
    log(f"bench: N={N} K={K} M={M} P={P} dtype={np.dtype(dtype).name} "
        f"batch={batch} impl={impl} device={device} [{card}]")

    res = run(N, K, M, P, dtype, batch=batch, impl=impl, phases=phases,
              device=device)
    log(f"probe: {res.probe!r}")
    log(f"launches over the timed total: {json.dumps(res.launches)}")
    if res.peak_bytes is not None:
        log(f"peak device memory of the run (max_memory_allocated): "
            f"{res.peak_bytes} B ({res.peak_bytes / 1e9:.2f} GB)")
    log("result: " + json.dumps(res._asdict()))

    folds_per_sec = P / res.total
    print(json.dumps({
        "metric": metric_name(N, K, P, dtype),
        "value": round(folds_per_sec, 1),
        "unit": "folds/s",
        "vs_baseline": round(folds_per_sec / BASELINE_FOLDS_PER_SEC, 3),
        "package": PACKAGE,
        "card": card,
    }), flush=True)
