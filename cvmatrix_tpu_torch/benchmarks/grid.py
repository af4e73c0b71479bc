"""Full-grid cross-validation benchmark of the PyTorch port.

Counterpart of ``benchmarks/benchmark.py``, with the same knobs, CSV schema
and methodology: total cross-validation time (one fit + the training
matrices of ALL folds) over P-fold splits of an (N, K) random dataset, swept
over preprocessing combinations and weighted/unweighted, appended to a CSV.
Run it as ``python -m cvmatrix_tpu_torch.benchmarks.grid``. Environment
knobs:

  BENCH_N (100000)   BENCH_K (500)      BENCH_M (10)
  BENCH_PS ("3,5,10,100,1000,10000,100000")
  BENCH_CONFIGS ("plot" = the 3 reference-figure combos | "all" = 16 |
                 flag strings such as "TTTT,FFTF")
  BENCH_BATCH (0 = the sweep's 4 GB chunk budget) fold-batch chunk size
  BENCH_NAIVE ("0")  also time the naive NumPy oracle (very slow)
  BENCH_NAIVE_ONLY ("0")  skip the fast engine (naive rows only)
  BENCH_NAIVE_SUBSET ("0")  time S folds, extrapolate to P (labeled)
  BENCH_DTYPE ("float64")
  BENCH_CSV ("benchmark_results.csv")
  BENCH_MODES ("warmjit" | any of "nojit,coldjit,warmjit,aotcold")
  BENCH_PLATFORM (unset = the CUDA card, which must be there; "cpu")
  BENCH_DATA ("random" | "nir": ``tests/data.nir_dataset``, the real set
             where ``CVMATRIX_TPU_NIR_CSV`` names a local copy, else its
             synthetic analogue; N and K come from the data)
  BENCH_PROBE_BW ("1")  time a pure store (``fill_`` of 1 GB) on the card
  BENCH_HBM_GBPS (3350, the H100's HBM3 rate)
  CVMATRIX_TPU_TORCH_CACHE (unset)  the kernel build directory, through
             ``enable_persistent_cache()``; the JAX grid's
             ``BENCH_PERSISTENT_CACHE`` has no counterpart: the kernel
             libraries persist in the checkout's build cache either way

Modes. ``warmjit``: one warm-up, then the fit alone, the sweep alone, the
total's first call, and the timed total: through ``materialize_cv`` where
every fold has one size (barrier ``fused-single``), else the fit and one
``materialize_sweep`` per fold-size bucket with one synchronisation at the
end (``single-chain``).
``coldjit``: the first fit and sweep of the row with no warm-up
(``sum-of-phases``); torch compiles nothing per shape, so only the first
row of a process pays the kernel libraries' load (and ``nvcc``, where they
are not built yet), and its barrier says so (``sum-of-phases+library-
load``). ``nojit``: the per-fold engine on each chunk of folds, no kernel
(``sum-of-phases``); the engine takes a (F, L) batch directly, the port's
counterpart of ``jax.vmap`` (``torch.func.vmap`` cannot run its host-side
index checks). ``aotcold``: the kernel libraries written by
:func:`~cvmatrix_tpu_torch.utils.aot.export_kernels` to the build
directory's ``export/`` (not timed), loaded through
:func:`~cvmatrix_tpu_torch.utils.aot.load_kernels`, then the first total
(``aot-first-call``); the card only, one fold size only.

Each printed line carries the card's name and power limit. ``gbps`` is the
fold phase's minimum traffic (:func:`fold_phase_bytes`) over its time, read
against ``BENCH_HBM_GBPS`` and the pure-store rate the card reaches. The
CSV is written with the ``csv`` module only: the card's machine has no
pandas; :mod:`cvmatrix_tpu_torch.benchmarks.plot` draws it on a host.
"""

from __future__ import annotations

import csv
import os
import subprocess
import sys
import time
from itertools import product
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# `barrier` labels how the `time` column was measured (the JAX grid's
# labels): fused-single (one materialize_cv, one synchronisation),
# single-chain (fit -> sweep per bucket, one synchronisation),
# sum-of-phases (time = fit_time + folds_time), aot-first-call (library
# load + first call), host (naive oracle rows). fit_time / folds_time are
# always from separate phased runs.
CSV_HEADER = (
    "model,weights,P,N,K,M,center_X,center_Y,scale_X,scale_Y,"
    "time,fit_time,folds_time,folds_per_sec,gbps,barrier,version,date\n"
)
PLOT_CONFIGS = ((False, False, False, False), (True, True, False, False),
                (True, True, True, True))


class Row(NamedTuple):
    """One grid row: the seconds of the fit, of the sweep and of the total
    (``warmjit`` without phases times no fit or sweep: ``None``), the
    total's barrier, the probe (the sum of the bucket probes), the kernel
    launches of the timed total (launched kernels only), the peak device
    memory of the row in bytes (``None`` on the CPU), and in ``warmjit``
    the seconds of the total's first call and of the warm-up (the kernels'
    build or load) where phases ran."""

    t_fit: Optional[float]
    t_folds: Optional[float]
    total: float
    barrier: str
    probe: float
    launches: Dict[str, int]
    peak_bytes: Optional[int]
    t_first: Optional[float] = None
    t_warmup: Optional[float] = None


def save_row(csv_path, **kw):
    """Append one row (every row carries its UTC date) in the file's own
    column order; a new file gets :data:`CSV_HEADER`."""
    kw.setdefault("date", time.strftime("%Y-%m-%d", time.gmtime()))
    try:
        with open(csv_path, "x") as f:
            f.write(CSV_HEADER)
        cols = CSV_HEADER.strip().split(",")
    except FileExistsError:
        with open(csv_path, newline="") as f:
            cols = next(csv.reader(f))
    with open(csv_path, "a", newline="") as f:
        csv.writer(f, lineterminator="\n").writerow(
            [str(kw.get(c, "")) for c in cols])


def fold_phase_bytes(P, n_val, K, M, itemsize, weighted):
    """Minimum memory traffic of the fold phase (the roofline numerator).

    Per fold: write XTX (K*K) + XTY (K*M) + stats; read the gathered
    validation rows (WX, X if weighted, Y, WY if weighted, w) and the
    replicated globals once per fold batch (amortised -> ignored).
    """
    out = K * K + K * M + 2 * K + 2 * M
    rows = n_val * (K * (2 if weighted else 1) + 2 * M + (1 if weighted else 0))
    return P * (out + rows) * itemsize


def bench_device(platform: Optional[str] = None) -> torch.device:
    """``BENCH_PLATFORM``'s device: unset or ``"cuda"`` the card, which must
    be there; ``"cpu"`` the host."""
    if platform in (None, "", "cuda", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA card: torch.cuda.is_available() is false; set "
                "BENCH_PLATFORM=cpu to run on the host.")
        return torch.device("cuda", torch.cuda.current_device())
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"BENCH_PLATFORM={platform!r}: expected cuda or cpu.")


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    ``"cpu (no card)"``."""
    if torch.device(device).type != "cuda":
        return "cpu (no card)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def fold_buckets(n: int, P: int):
    """``Partitioner(np.arange(n) % P)``'s folds as (F, L) stacks, one per
    fold size, in first-appearance order (JAX ``benchmark.py:93-97``)."""
    from ..models.partitioner import Partitioner

    buckets: Dict[int, list] = {}
    for v in Partitioner(np.arange(n) % P).folds_dict.values():
        buckets.setdefault(v.size, []).append(v)
    return [np.stack(vs) for vs in buckets.values()]


def probe_folds(config, stacks, k: int, m: int, batch, mode: str):
    """The folds whose XTX[0, 0] + XTY[0, 0] a row's probe sums: in
    ``nojit`` each chunk's first fold, else each bucket's probe fold (the
    first of :func:`~cvmatrix_tpu_torch.models.sweep.sweep_last_chunk`)."""
    from ..models.sweep import sweep_last_chunk

    if mode == "nojit":
        b = batch or 500
        return [s[off] for s in stacks for off in range(0, s.shape[0], b)]
    return [sweep_last_chunk(config, s, k, k + m, batch)[0] for s in stacks]


def run_row(flags, P, X, Y, weights, batch, mode="warmjit",
            device="cuda", *, impl: str = "auto",
            phases: bool = True) -> Optional[Row]:
    """One grid row on ``device``: ``X``, ``Y`` and ``weights`` (or
    ``None``) as arrays or tensors, moved there first (not timed); the
    dtype is ``X``'s; ``impl`` is the sweeps' kernel route. Returns
    ``None`` where the mode does not apply (aotcold on the CPU or over
    several fold sizes).

    ``warmjit`` in order: with ``phases``, a warm-up fit and sweep, then
    the fit and the sweep timed apart; the total's first call; then the
    timed total. Each timed step ends with the card's
    synchronisation and, where it yields a probe, the host fetch of it.
    """
    from .. import CVConfig
    from ..core.fit import fit
    from ..core.fold import training_XTX_XTY
    from ..models.sweep import materialize_cv, materialize_sweep
    from ..ops import _build, launch_counts, reset_launch_counts
    from ..utils.profiling import Stopwatch

    device = torch.device(device)
    cuda = device.type == "cuda"
    Xd, Yd, wd = (None if a is None else torch.as_tensor(a).to(device)
                  for a in (X, Y, weights))
    np_dtype = np.float64 if Xd.dtype == torch.float64 else np.float32
    cfg = CVConfig(*flags, ddof=1, dtype=np_dtype)
    stacks = fold_buckets(Xd.shape[0], P)
    if mode == "aotcold" and (not cuda or len(stacks) != 1):
        print(f"aotcold: skipped (P={P}: "
              + ("no kernel libraries on the CPU" if not cuda else
                 f"{len(stacks)} fold-size buckets; the fused total needs 1")
              + ")", flush=True)
        return None
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    def peak():
        return torch.cuda.max_memory_allocated(device) if cuda else None

    def watch():
        return Stopwatch(device=device)

    def fit_once():
        return fit(cfg, Xd, Yd, wd, validate=False, copy=False)

    def sweep_probe(st):
        # one sweep per size bucket; the probes summed on the device
        s = None
        for stack in stacks:
            p = materialize_sweep(cfg, st, stack, batch_size=batch,
                                  impl=impl)
            s = p if s is None else s + p
        return s

    def total_cv():
        if len(stacks) == 1:
            return materialize_cv(cfg, Xd, Yd, wd, stacks[0],
                                  batch_size=batch, impl=impl, validate=False)
        return sweep_probe(fit_once())

    if mode == "nojit":
        reset_launch_counts()
        with watch() as sw:
            st = fit_once()
        t_fit = sw.elapsed
        b = batch or 500
        with watch() as sw:
            s = torch.zeros((), dtype=torch.float64, device=device)
            for stack in stacks:
                for off in range(0, stack.shape[0], b):
                    (xtx, xty), _ = training_XTX_XTY(
                        cfg, st, torch.from_numpy(stack[off:off + b]).to(device))
                    s = s + (xtx[0, 0, 0] + xty[0, 0, 0]).to(torch.float64)
        return Row(t_fit, sw.elapsed, t_fit + sw.elapsed, "sum-of-phases",
                   float(s), launch_counts(), peak())

    if mode == "aotcold":
        from ..utils.aot import export_kernels, load_kernels

        path = os.path.join(_build.build_dir(), "export")
        export_kernels(path)  # not timed: it ships with the libraries
        t0 = time.perf_counter()
        load_kernels(path)
        t_load = time.perf_counter() - t0
        reset_launch_counts()
        with watch() as sw:
            p = total_cv()
        return Row(t_load, sw.elapsed, t_load + sw.elapsed, "aot-first-call",
                   float(p), launch_counts(), peak())

    if mode == "coldjit":
        loaded = set(_build._LIBS)
        reset_launch_counts()
        with watch() as sw:
            st = fit_once()
        t_fit = sw.elapsed
        with watch() as sw:
            s = sweep_probe(st)
        barrier = "sum-of-phases" + (
            "+library-load" if set(_build._LIBS) - loaded else "")
        return Row(t_fit, sw.elapsed, t_fit + sw.elapsed, barrier, float(s),
                   launch_counts(), peak())

    if mode != "warmjit":
        raise ValueError(f"unknown mode {mode!r} "
                         "(warmjit|coldjit|nojit|aotcold)")
    t_warmup = t_fit = t_folds = None
    if phases:
        with watch() as sw:
            float(sweep_probe(fit_once()))  # pays the kernels' build or load
        t_warmup = sw.elapsed
        with watch() as sw:
            st = fit_once()
        t_fit = sw.elapsed
        with watch() as sw:
            float(sweep_probe(st))
        t_folds = sw.elapsed
        del st  # never two states at once
    with watch() as sw:
        float(total_cv())
    t_first = sw.elapsed
    reset_launch_counts()
    with watch() as sw:
        s = float(total_cv())
    return Row(t_fit, t_folds, sw.elapsed,
               "fused-single" if len(stacks) == 1 else "single-chain", s,
               launch_counts(), peak(), t_first, t_warmup)


def record_row(csv_path, row: Row, *, mode, flags, P, use_w, N, K, M,
               itemsize, device_type, card, hbm_roof=3350.0,
               store_roof=None) -> str:
    """Append ``row`` to ``csv_path`` (model ``CVMatrix-torch-{device
    type}-{mode}``) and return its log line."""
    from .. import __version__

    if row.barrier == "aot-first-call":
        gbps = None
        detail = (f"(load {row.t_fit:.4f} + first-call {row.t_folds:.4f}) "
                  "cold via shipped libraries")
    else:
        gbps = fold_phase_bytes(P, N // P, K, M, itemsize,
                                use_w) / row.t_folds / 1e9
        ref_s = f"{gbps / hbm_roof:.0%} of {hbm_roof:.0f} GB/s"
        if store_roof:
            ref_s += f"; measured pure-store ceiling {store_roof:.0f} GB/s"
        detail = (f"(fit {row.t_fit:.4f} + folds {row.t_folds:.4f}) "
                  f"{P / row.total:,.0f} folds/s, {gbps:.0f} GB/s ({ref_s})")
    model = f"CVMatrix-torch-{device_type}-{mode}"
    save_row(
        csv_path, model=model, weights=use_w, P=P, N=N, K=K, M=M,
        center_X=flags[0], center_Y=flags[1], scale_X=flags[2],
        scale_Y=flags[3], time=round(row.total, 4),
        fit_time=round(row.t_fit, 4), folds_time=round(row.t_folds, 4),
        folds_per_sec=round(P / row.total, 1),
        gbps="" if gbps is None else round(gbps, 1),
        barrier=row.barrier, version=__version__,
    )
    peak = ("" if row.peak_bytes is None
            else f", peak {row.peak_bytes / 1e9:.2f} GB")
    return (f"{model} w={use_w} P={P} flags={flags}: total={row.total:.4f}s "
            f"{detail}; {row.barrier}; probe {row.probe!r}; launches "
            f"{row.launches}{peak}  [{card}]")


def measure_write_bw(device, n_mb: int = 1000, reps: int = 50) -> float:
    """Pure-store rate of the card (GB/s): ``fill_`` of ``n_mb`` MB, timed
    between CUDA events over ``reps`` calls after one warm call. The fold
    phase is store-dominated, so its GB/s is read against this ceiling as
    well as the data sheet's rate."""
    buf = torch.empty(n_mb * (1 << 20) // 4, dtype=torch.float32,
                      device=device)
    buf.fill_(1.0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        buf.fill_(float(i))
    end.record()
    end.synchronize()
    return reps * buf.numel() * 4 / (start.elapsed_time(end) / 1e3) / 1e9


def run_naive(cfg_flags, P, X, Y, weights):
    """Naive-oracle total CV time on the host; returns (seconds,
    extrapolated_flag), as the JAX grid's ``run_naive``.

    BENCH_NAIVE_SUBSET=S (0 = off) times S folds and extrapolates linearly
    to P (each fold recomputes a same-size training block); such rows are
    labeled (model suffix and barrier).
    """
    sys.path.insert(0, os.path.join(_ROOT, "tests"))
    from oracle import NaiveOracle

    cx, cy, sx, sy = cfg_flags
    n = X.shape[0]
    folds = np.arange(n) % P
    subset = int(os.environ.get("BENCH_NAIVE_SUBSET", 0))
    n_folds = P if not subset else min(subset, P)
    t0 = time.perf_counter()
    o = NaiveOracle(cx, cy, sx, sy, ddof=1, dtype=X.dtype).fit(X, Y, weights)
    all_idx = np.arange(n)
    for f in range(n_folds):
        o.training_XTX_XTY(all_idx[folds != f])
    t = time.perf_counter() - t0
    if n_folds == P:
        return t, False
    t_fit = time.perf_counter()  # re-measure fit to subtract before scaling
    NaiveOracle(cx, cy, sx, sy, ddof=1, dtype=X.dtype).fit(X, Y, weights)
    t_fit = time.perf_counter() - t_fit
    return t_fit + (t - t_fit) * (P / n_folds), True


def grid_configs(spec: str):
    """``BENCH_CONFIGS``: "plot", "all" or comma-separated flag strings."""
    if spec == "plot":
        return list(PLOT_CONFIGS)
    if spec == "all":
        return list(product([True, False], repeat=4))
    return [tuple(ch == "T" for ch in s) for s in spec.split(",")]


def main():
    from .. import __version__
    from ..utils import enable_persistent_cache

    device = bench_device(os.environ.get("BENCH_PLATFORM"))
    if os.environ.get("CVMATRIX_TPU_TORCH_CACHE"):
        print("kernel build cache:", enable_persistent_cache(),
              file=sys.stderr, flush=True)

    N = int(os.environ.get("BENCH_N", 100_000))
    K = int(os.environ.get("BENCH_K", 500))
    M = int(os.environ.get("BENCH_M", 10))
    Ps = [int(x) for x in os.environ.get(
        "BENCH_PS", "3,5,10,100,1000,10000,100000").split(",")]
    dtype = np.dtype(os.environ.get("BENCH_DTYPE", "float64"))
    batch = int(os.environ.get("BENCH_BATCH", 0)) or None  # None: 4 GB budget
    csv_path = os.environ.get("BENCH_CSV", "benchmark_results.csv")
    modes = os.environ.get("BENCH_MODES", "warmjit").split(",")
    configs = grid_configs(os.environ.get("BENCH_CONFIGS", "plot"))
    card = card_line(device)
    hbm_roof = float(os.environ.get("BENCH_HBM_GBPS", 3350.0))
    store_roof = None
    if os.environ.get("BENCH_PROBE_BW", "1") == "1":
        if device.type == "cuda":
            store_roof = measure_write_bw(device)
            print(f"measured store bandwidth: {store_roof:.0f} GB/s "
                  f"(data sheet {hbm_roof:.0f})  [{card}]", flush=True)
        else:
            print("store-bw probe skipped: no card", flush=True)

    if os.environ.get("BENCH_DATA", "random") == "nir":
        sys.path.insert(0, os.path.join(_ROOT, "tests"))
        from data import nir_dataset

        Xn, Yn, _, wn = nir_dataset(m=min(M, 10))
        X, Y, weights = (a.astype(dtype) for a in (Xn, Yn, wn))
        N, K = X.shape
        M = Y.shape[1]
        print(f"BENCH_DATA=nir: N={N} K={K} M={M}", flush=True)
    else:
        rng = np.random.default_rng(42)
        X = rng.random((N, K)).astype(dtype)
        Y = rng.random((N, M)).astype(dtype)
        weights = rng.random(N).astype(dtype)
    Xd, Yd, wdev = (torch.from_numpy(a).to(device) for a in (X, Y, weights))

    naive_only = os.environ.get("BENCH_NAIVE_ONLY", "0") == "1"
    for use_w, flags, P in product([True, False], configs, Ps):
        for mode in modes:
            if naive_only:
                break
            row = run_row(flags, P, Xd, Yd, wdev if use_w else None, batch,
                          mode, device)
            if row is None:
                continue
            print(record_row(csv_path, row, mode=mode, flags=flags, P=P,
                             use_w=use_w, N=N, K=K, M=M,
                             itemsize=dtype.itemsize,
                             device_type=device.type, card=card,
                             hbm_roof=hbm_roof, store_roof=store_roof),
                  flush=True)
        if os.environ.get("BENCH_NAIVE", "0") == "1":
            t, extrap = run_naive(flags, P, X, Y, weights if use_w else None)
            tag = "-extrapolated" if extrap else ""
            print(f"NaiveOracle{tag} w={use_w} P={P} flags={flags}: "
                  f"{t:.2f}s", flush=True)
            save_row(
                csv_path, model=f"NaiveOracle{tag}", weights=use_w, P=P,
                N=N, K=K, M=M, center_X=flags[0], center_Y=flags[1],
                scale_X=flags[2], scale_Y=flags[3], time=round(t, 4),
                barrier="host-extrapolated" if extrap else "host",
                version=__version__,
            )


if __name__ == "__main__":
    main()
