#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cvmatrix_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``)::

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. Device: require CUDA; print the card, its power limit and the toolchain.
2. Build: compile the LOOCV kernel from ``cvmatrix_tpu_torch/csrc/loocv.cu``.
3. Kernel against its plain twin on the card: 16 flag sets x weighted and
   unweighted at N=2,000, K=500, M=10 over 64 folds, and the main path's
   first and last 256 folds; bound max|kernel - twin| <= 1e-12 max|twin|.
   Times one 971-fold chunk through the kernel and through the twin.
4. Main path: weighted, all four centre/scale flags on, float64,
   N=100,000, K=500, M=10, seed 42, leave-one-out over all 100,000 folds
   through ``materialize_cv``, once to warm up and once timed, with the
   kernel's launch count read around the timed run. Also times the fit
   alone and the fold sweep alone, through the kernel and the plain twin.
5. Oracle: the main path's probe and two folds' full matrices against the
   NumPy oracle ``tests/oracle.py``.
6. Prints the kernels' JSON line, the card's name and power limit, and as
   the last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import importlib.util
import itertools
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

N, K, M, SEED = 100_000, 500, 10, 42
TWIN_RTOL = 1e-12
ORACLE_RTOL = 1e-10


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` between CUDA events (warm)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall(fn):
    """(seconds, result) of ``fn`` between two device synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, res


def main() -> int:
    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card.", file=sys.stderr)
        return 1
    from cvmatrix_tpu_torch import CVConfig, Partitioner, fit
    from cvmatrix_tpu_torch.core.batch import (
        loocv_from_sources,
        prepare_loocv_sources,
    )
    from cvmatrix_tpu_torch.models.sweep import (
        chunking,
        materialize_cv,
        materialize_sweep,
    )
    from cvmatrix_tpu_torch.ops import _build
    from cvmatrix_tpu_torch.ops.loocv import fused_loocv
    from tests.oracle import NaiveOracle

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    nvcc = _build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True,
                              timeout=60).stdout.strip().splitlines()[-1]
    triton = importlib.util.find_spec("triton")
    log(f"[device] {card}")
    log(f"[device] {kind}; {torch.cuda.device_count()} card(s); python "
        f"{sys.version.split()[0]}; torch {torch.__version__}; "
        f"torch.version.cuda {torch.version.cuda}")
    log(f"[device] nvcc {nvcc}: {nvcc_ver}; ninja "
        f"{shutil.which('ninja') or 'absent'}; triton "
        f"{'present' if triton else 'absent'}")

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library("loocv")
    log(f"[build] loocv.cu -> {_build.build_dir()} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in _build.BUILD_LOG.get("loocv", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # ---- 3. kernel against twin -------------------------------------------
    def twin(cfg, state, rows, with_y):
        src = prepare_loocv_sources(cfg, state, rows, return_XTY=with_y)
        got = loocv_from_sources(cfg, src, rows, return_XTY=with_y,
                                 impl="cuda")
        ref = loocv_from_sources(cfg, src, rows, return_XTY=with_y,
                                 impl="torch")
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not err <= TWIN_RTOL * scale:
            raise AssertionError(
                f"kernel vs twin: max|diff| {err:.3e} > {TWIN_RTOL:g} * "
                f"{scale:.3e} ({cfg}, with_y={with_y})"
            )
        return err, err / scale

    rng = np.random.default_rng(SEED)
    n_small = 2_000
    Xs = rng.random((n_small, K))
    Ys = rng.random((n_small, M))
    ws = rng.random(n_small)
    ws[::7] = 0.0
    rows_small = np.sort(rng.choice(n_small, 64, replace=False))
    worst_abs = worst_rel = 0.0
    cases = 0
    for flags in itertools.product([True, False], repeat=4):
        for w in (ws, None):
            cfg = CVConfig(*flags, ddof=1, dtype=np.float64)
            st = fit(cfg, Xs, Ys, w, device=dev)
            with_ys = (True, False) if flags in (
                (True,) * 4, (False,) * 4) else (True,)
            for with_y in with_ys:
                a, r = twin(cfg, st, rows_small, with_y)
                worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
                cases += 1
    log(f"[twin] {cases} small cases (N={n_small}, 64 folds): worst "
        f"max|diff| {worst_abs:.3e}, worst relative {worst_rel:.3e}")

    rng = np.random.default_rng(SEED)
    X = rng.random((N, K), dtype=np.float64)
    Y = rng.random((N, M), dtype=np.float64)
    weights = rng.random(N)
    cfg = CVConfig(True, True, True, True, ddof=1, dtype=np.float64)
    Xd, Yd, wd = (torch.from_numpy(a).to(dev) for a in (X, Y, weights))
    st = fit(cfg, Xd, Yd, wd, copy=False)
    for rows in (np.arange(256), np.arange(N - 256, N)):
        a, r = twin(cfg, st, rows, True)
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
        log(f"[twin] full N, folds {rows[0]}..{rows[-1]}: max|diff| "
            f"{a:.3e}, relative {r:.3e}")

    bs, n_chunks = chunking(N, K, K + M)
    rows_chunk = torch.arange(bs, dtype=torch.int64).pin_memory()
    src = prepare_loocv_sources(cfg, st, rows_chunk)
    buf = torch.empty((bs, K, K + M), dtype=torch.float64, device=dev)
    run = {
        impl: (lambda impl=impl: loocv_from_sources(
            cfg, src, rows_chunk, return_XTY=True, impl=impl,
            out=buf if impl == "cuda" else None))
        for impl in ("cuda", "torch")
    }
    chunk_ms = {"torch": [], "cuda": []}
    for impl in ("torch", "cuda", "cuda", "torch"):
        chunk_ms[impl].append(cuda_ms(run[impl], 20 if impl == "cuda" else 3))
    kernel_ms, plain_ms = min(chunk_ms["cuda"]), min(chunk_ms["torch"])
    chunk_bytes = bs * K * (K + M) * 8
    log(f"[twin] one {bs}-fold chunk at K={K}, M={M} ({chunk_bytes / 1e9:.3f} "
        f"GB out): kernel {chunk_ms['cuda']} ms, plain {chunk_ms['torch']} ms "
        f"(plain, kernel, kernel, plain); kernel writes "
        f"{chunk_bytes / kernel_ms / 1e6:.1f} GB/s  [{card}]")
    del src, buf, st

    # ---- 4. main path -------------------------------------------------------
    idx = Partitioner(np.arange(N)).padded_batches()[1]

    def total_cv():
        return float(materialize_cv(cfg, Xd, Yd, wd, idx))

    t_warm, _ = wall(total_cv)
    fused_loocv.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t_total, probe = wall(total_cv)
    launches = fused_loocv.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != n_chunks:
        raise AssertionError(
            f"main path launched the LOOCV kernel {launches} times, expected "
            f"{n_chunks} (one per chunk)"
        )
    if not np.isfinite(probe):
        raise AssertionError(f"main-path probe is not finite: {probe}")
    t_fit, st = wall(lambda: fit(cfg, Xd, Yd, wd, copy=False))
    sweeps = {"torch": [], "cuda": []}
    for impl in ("torch", "cuda", "cuda", "torch"):
        sweeps[impl].append(wall(lambda: float(
            materialize_sweep(cfg, st, idx, impl=impl)))[0])
    floor_s = N * K * (K + M) * 8 / 3.35e12
    log(f"[main] weighted TTTT f64 N={N} K={K} M={M} P={N} (LOOCV), "
        f"{n_chunks} chunks of {bs}  [{card}]")
    log(f"[main] materialize_cv: warm-up {t_warm:.4f} s, timed total "
        f"{t_total:.4f} s -> {N / t_total:,.0f} folds/s; probe {probe!r}; "
        f"kernel launches {launches}; peak device memory {peak_gb:.2f} GB")
    log(f"[main] fit alone {t_fit:.4f} s; fold sweep alone: kernel "
        f"{sweeps['cuda']} s, plain twin {sweeps['torch']} s "
        f"(plain, kernel, kernel, plain); write floor at 3.35 TB/s "
        f"{floor_s:.4f} s")

    # ---- 5. oracle ------------------------------------------------------------
    naive = NaiveOracle(True, True, True, True, ddof=1).fit(X, Y, weights)
    all_rows = np.arange(N)

    def oracle(fold):
        (xtx, xty), _ = naive.training_XTX_XTY(np.delete(all_rows, fold))
        return np.concatenate([xtx, xty], axis=1)

    f_probe = (n_chunks - 1) * bs
    ref = oracle(f_probe)
    expect = float(ref[0, 0] + ref[0, K])
    if not abs(probe - expect) <= ORACLE_RTOL * abs(expect):
        raise AssertionError(f"probe {probe!r} vs oracle {expect!r} (fold "
                             f"{f_probe})")
    log(f"[oracle] main-path probe (fold {f_probe}) {probe!r} vs oracle "
        f"{expect!r}: relative {abs(probe - expect) / abs(expect):.3e}")
    folds = np.array([0, N - 1])
    src = prepare_loocv_sources(cfg, st, folds)
    got = loocv_from_sources(cfg, src, folds, return_XTY=True,
                             impl="cuda").cpu().numpy()
    for i, fold in enumerate(folds):
        ref = oracle(fold)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got[i], ref, rtol=ORACLE_RTOL,
                                   atol=ORACLE_RTOL * scale)
        log(f"[oracle] fold {fold}: max|kernel - oracle| "
            f"{np.abs(got[i] - ref).max():.3e} (max|oracle| {scale:.3e})")

    # ---- 6. result -----------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "fused_loocv",
        "route": "cuda",
        "source": "cvmatrix_tpu_torch/csrc/loocv.cu",
        "replaces": "cvmatrix_tpu/ops/kernels.py:892",
        "launches": launches,
        "max_abs_err": worst_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
