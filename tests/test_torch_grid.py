"""The port's reference grid (``cvmatrix_tpu_torch.benchmarks.grid``)
beside the JAX grid (``benchmarks/benchmark.py``): each row's probe against
the sum of the JAX ``materialize_sweep`` bucket probes, the CSV schema and
rules, the figures, and one run of the module on the CPU."""

import csv
import functools
import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import cvmatrix_tpu as J
from cvmatrix_tpu.models import sweep as JS
from cvmatrix_tpu_torch import CVConfig, fit
from cvmatrix_tpu_torch.benchmarks import grid as G
from cvmatrix_tpu_torch.core.fold import training_XTX_XTY

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, K, M = 240, 12, 3
PS = (3, 5, 7, 10, 240)  # 7: two fold sizes (35 and 34 rows)


def _load_jax_grid():
    spec = importlib.util.spec_from_file_location(
        "jax_benchmark_grid", ROOT / "benchmarks" / "benchmark.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JG = _load_jax_grid()


@functools.lru_cache(maxsize=None)
def _data(dtype):
    rng = np.random.default_rng(42)
    X = rng.random((N, K)).astype(dtype)
    Y = rng.random((N, M)).astype(dtype)
    return X, Y, rng.random(N).astype(dtype)


@functools.lru_cache(maxsize=None)
def _jax_probe(flags, weighted, dtype, P):
    """What the JAX grid's ``run_all_folds`` sums: one ``materialize_sweep``
    probe a fold-size bucket."""
    X, Y, w = _data(dtype)
    cfg = J.CVConfig(*flags, ddof=1, dtype=dtype)
    st = J.fit(cfg, X, Y, w if weighted else None, validate=False)
    buckets = {}
    for v in J.Partitioner(np.arange(N) % P).folds_dict.values():
        buckets.setdefault(v.size, []).append(v)
    return sum(float(JS.materialize_sweep(cfg, st, np.stack(vs)))
               for vs in buckets.values())


def _scale(flags, weighted, dtype, P, mode="warmjit"):
    """The largest entry of the probe folds' [XTX | XTY] (float64)."""
    X, Y, w = (a.astype(np.float64) for a in _data(dtype))
    cfg = CVConfig(*flags, ddof=1)
    st = fit(cfg, X, Y, w if weighted else None, device="cpu")
    folds = G.probe_folds(CVConfig(*flags, ddof=1, dtype=dtype),
                          G.fold_buckets(N, P), K, M, None, mode)
    return max(float(torch.cat(training_XTX_XTY(cfg, st, f)[0], 1)
                     .abs().max()) for f in folds)


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("flags", G.PLOT_CONFIGS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_run_row_probe_matches_jax_grid(dtype, flags, weighted, P):
    X, Y, w = _data(dtype)
    row = G.run_row(flags, P, X, Y, w if weighted else None, None,
                    "warmjit", "cpu")
    ref = _jax_probe(flags, weighted, dtype, P)
    if dtype == np.float64:
        assert abs(row.probe - ref) <= 1e-10 * abs(ref)
    else:
        assert abs(row.probe - ref) <= 1e-4 * _scale(flags, weighted, dtype,
                                                     P)
    n_buckets = len(G.fold_buckets(N, P))
    assert row.barrier == ("fused-single" if n_buckets == 1
                           else "single-chain")
    assert row.launches == {} and row.peak_bytes is None
    assert min(row.t_fit, row.t_folds, row.total) > 0


@pytest.mark.parametrize("P", [3, 10, 240])
@pytest.mark.parametrize("mode", ["nojit", "coldjit"])
def test_other_modes_probe_their_folds(mode, P):
    """coldjit sums what the JAX grid's sweep sums; nojit each chunk's
    first fold, from the per-fold engine (JAX ``benchmark.py:123-142``)."""
    X, Y, w = _data(np.float64)
    flags = (True,) * 4
    row = G.run_row(flags, P, X, Y, w, 100, mode, "cpu")
    cfg = CVConfig(*flags, ddof=1)
    st = fit(cfg, X, Y, w, device="cpu")
    want = 0.0
    for f in G.probe_folds(cfg, G.fold_buckets(N, P), K, M, 100, mode):
        (xtx, xty), _ = training_XTX_XTY(cfg, st, f)
        want += float(xtx[0, 0] + xty[0, 0])
    assert abs(row.probe - want) <= 1e-10 * abs(want)
    assert row.barrier == "sum-of-phases" and row.launches == {}
    assert row.total == pytest.approx(row.t_fit + row.t_folds)
    if mode == "coldjit":
        jax_sum = sum(float(JS.materialize_sweep(
            J.CVConfig(*flags, ddof=1),
            J.fit(J.CVConfig(*flags, ddof=1), X, Y, w), s, batch_size=100))
            for s in G.fold_buckets(N, P))
        assert abs(row.probe - jax_sum) <= 1e-10 * abs(jax_sum)


def test_aotcold_needs_the_card():
    X, Y, w = _data(np.float64)
    assert G.run_row((True,) * 4, 10, X, Y, w, None, "aotcold", "cpu") is None
    with pytest.raises(ValueError, match="unknown mode"):
        G.run_row((True,) * 4, 10, X, Y, w, None, "hotjit", "cpu")


def test_fold_buckets_are_the_jax_grids():
    for P in (3, 7, 240):
        got = G.fold_buckets(N, P)
        buckets = {}
        for v in J.Partitioner(np.arange(N) % P).folds_dict.values():
            buckets.setdefault(v.size, []).append(v)
        want = [np.stack(vs) for vs in buckets.values()]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_csv_header_and_cost_are_the_jax_grids():
    assert G.CSV_HEADER == JG.CSV_HEADER
    for args in [(3, 33_333, 500, 10, 8, True), (100_000, 1, 500, 10, 4,
                                                 False)]:
        assert G.fold_phase_bytes(*args) == JG.fold_phase_bytes(*args)
    assert G.grid_configs("plot") == list(G.PLOT_CONFIGS)
    assert len(G.grid_configs("all")) == 16
    assert G.grid_configs("TTFF,FFTF") == [(True, True, False, False),
                                            (False, False, True, False)]


@pytest.mark.parametrize("old_schema", [False, True])
def test_save_row_writes_what_the_jax_grid_writes(tmp_path, old_schema):
    rows = [dict(model="CVMatrix-torch-cpu-warmjit", weights=True, P=10,
                 N=N, K=K, M=M, center_X=True, center_Y=False, scale_X=True,
                 scale_Y=False, time=0.0123, fit_time=0.001,
                 folds_time=0.0113, folds_per_sec=813.0, gbps="",
                 barrier="fused-single", version="0.1.0", date="2026-10-17"),
            dict(model="NaiveOracle", weights=False, P=3, N=N, K=K, M=M,
                 center_X=False, center_Y=False, scale_X=False,
                 scale_Y=False, time=1.5, barrier="host", version="0.1.0",
                 date="2026-10-17")]
    paths = [tmp_path / "port.csv", tmp_path / "jax.csv"]
    if old_schema:  # a file from before the barrier column keeps its order
        for p in paths:
            p.write_text(JG.CSV_HEADER.replace("barrier,", ""))
    for kw in rows:
        G.save_row(str(paths[0]), **kw)
        JG.save_row(str(paths[1]), **kw)
    assert paths[0].read_text() == paths[1].read_text()


def test_bench_device_needs_a_card_unless_cpu():
    assert G.bench_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="BENCH_PLATFORM=cpu"):
            G.bench_device(None)
    with pytest.raises(ValueError):
        G.bench_device("tpu")
    assert G.card_line("cpu") == "cpu (no card)"


@pytest.fixture(scope="module")
def grid_csv(tmp_path_factory):
    """One run of the grid module on the CPU at the test size, with the
    naive oracle and two modes (so every figure family has rows)."""
    out = tmp_path_factory.mktemp("grid") / "grid_cpu.csv"
    env = {**os.environ, "BENCH_PLATFORM": "cpu", "BENCH_N": str(N),
           "BENCH_K": str(K), "BENCH_M": str(M), "BENCH_PS": "7,10,240",
           "BENCH_CSV": str(out), "BENCH_MODES": "nojit,warmjit",
           "BENCH_NAIVE": "1", "BENCH_PERSISTENT_CACHE": "0",
           "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-m",
                          "cvmatrix_tpu_torch.benchmarks.grid"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return out, res.stdout


def test_grid_module_writes_the_jax_schema(grid_csv):
    out, stdout = grid_csv
    with open(out, newline="") as f:
        header = f.readline()
        rows = list(csv.DictReader(f, fieldnames=header.strip().split(",")))
    assert header == JG.CSV_HEADER
    assert len(rows) == 2 * 3 * 3 * 3  # weights x configs x Ps x (2 modes + naive)
    models = {r["model"] for r in rows}
    assert models == {"CVMatrix-torch-cpu-nojit", "CVMatrix-torch-cpu-warmjit",
                      "NaiveOracle"}
    barriers = {(r["model"], r["P"]): r["barrier"] for r in rows}
    assert barriers["CVMatrix-torch-cpu-warmjit", "7"] == "single-chain"
    assert barriers["CVMatrix-torch-cpu-warmjit", "10"] == "fused-single"
    assert barriers["CVMatrix-torch-cpu-nojit", "10"] == "sum-of-phases"
    assert barriers["NaiveOracle", "10"] == "host"
    for r in rows:
        assert float(r["time"]) > 0 and r["version"] and r["date"]
    assert stdout.count("[cpu (no card)]") == 2 * 3 * 3 * 2


@pytest.mark.parametrize("suffix", ["_vs_naive.png", "_combos.png",
                                    "_roofline.png", "_jit_modes.png"])
def test_plot_renders_each_figure_family(grid_csv, tmp_path, suffix):
    from cvmatrix_tpu_torch.benchmarks import plot

    csv_path = tmp_path / "grid.csv"
    csv_path.write_bytes(grid_csv[0].read_bytes())
    written = plot.plot_csv(str(csv_path))
    out = str(tmp_path / ("grid" + suffix))
    assert out in written and os.path.getsize(out) > 1000
