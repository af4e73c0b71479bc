"""The port's bench entry (``bench_torch.py``, ``cvmatrix_tpu_torch.bench``)
beside the JAX entry (``bench.py``): the printed line, the probe against the
JAX package's ``materialize_cv`` / ``materialize_sweep``, the knobs that
raise, and the device watchdog. All on the CPU at N=300, K=12, M=3."""

import json
import os
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import cvmatrix_tpu as J
from cvmatrix_tpu.models import sweep as JS
from cvmatrix_tpu_torch import bench as B
from cvmatrix_tpu_torch.benchmarks.grid import fold_buckets

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, K, M = 300, 12, 3
ENV = {"BENCH_PLATFORM": "cpu", "BENCH_AOT": "0",
       "BENCH_PERSISTENT_CACHE": "0", "BENCH_N": str(N), "BENCH_K": str(K),
       "BENCH_M": str(M)}
# (P, dtype) of the entries' runs: LOOCV, and P=7 (fold sizes 43 and 42)
CASES = [(p, dt) for p in (N, 7) for dt in ("float64", "float32")]
RTOL = {np.float64: 1e-12, np.float32: 1e-5}


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    return {**env, **ENV, **extra}


def _entry(script, P, dtype):
    return subprocess.run(
        [sys.executable, script], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=_env(BENCH_P=str(P), BENCH_DTYPE=dtype))


@pytest.fixture(scope="module")
def entry_runs():
    """Both entries at every case, four processes at a time."""
    jobs = [(s, p, dt) for p, dt in CASES for s in ("bench.py",
                                                    "bench_torch.py")]
    with ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(lambda j: _entry(*j), jobs))
    return dict(zip(jobs, outs))


def _line(res):
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert len(lines) == 1, res.stdout
    return json.loads(lines[0])


@pytest.mark.parametrize("P, dtype", CASES)
def test_entries_print_one_line_under_one_metric(entry_runs, P, dtype):
    jax_line = _line(entry_runs["bench.py", P, dtype])
    torch_line = _line(entry_runs["bench_torch.py", P, dtype])
    assert torch_line["metric"] == jax_line["metric"] == (
        f"weighted_TTTT_P{P}_total_cv_folds_per_sec_n{N}_k{K}_{dtype}")
    assert torch_line["unit"] == jax_line["unit"] == "folds/s"
    assert jax_line["value"] > 0 and torch_line["value"] > 0
    assert torch_line["vs_baseline"] == pytest.approx(
        torch_line["value"] / (100_000 / 1.299), abs=2e-3)
    assert torch_line["package"] == "cvmatrix_tpu_torch"
    assert torch_line["card"] == "cpu (no card)"
    err = entry_runs["bench_torch.py", P, dtype].stderr
    assert "launches over the timed total: {}" in err  # no kernel on the CPU
    result = json.loads(err.split("result: ", 1)[1].splitlines()[0])
    assert result["total"] > 0 and np.isfinite(result["probe"])
    assert f"probe: {result['probe']!r}" in err


def _jax_probe(P, dtype):
    """``bench.py``'s total on the same data: one ``materialize_cv`` for one
    fold size, else one fit and one ``materialize_sweep`` a size, summed."""
    X, Y, w = B.bench_data(N, K, M, dtype)
    cfg = J.CVConfig(True, True, True, True, ddof=1, dtype=dtype)
    stacks = fold_buckets(N, P)
    if len(stacks) == 1:
        return float(JS.materialize_cv(cfg, X, Y, w, stacks[0],
                                       validate=False))
    st = J.fit(cfg, X, Y, w, validate=False)
    return sum(float(JS.materialize_sweep(cfg, st, s)) for s in stacks)


@pytest.mark.parametrize("P", [N, 30, 7, 3])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_run_probe_matches_jax(P, dtype):
    res = B.run(N, K, M, P, dtype, device="cpu", say=lambda *a: None)
    want = _jax_probe(P, dtype)
    assert abs(res.probe - want) <= RTOL[dtype] * abs(want), (res.probe,
                                                              want)
    assert res.launches == {} and res.peak_bytes is None
    assert res.barrier == ("fused-single" if len(fold_buckets(N, P)) == 1
                           else "single-chain")
    assert min(res.total, res.t_first, res.t_warmup, res.t_fit,
               res.t_folds) > 0


def test_run_without_phases_times_only_the_total():
    lines = []
    res = B.run(N, K, M, 7, phases=False, device="cpu", say=lines.append)
    assert res.t_fit is None and res.t_folds is None and res.t_warmup is None
    assert res.t_first > 0 and res.total > 0
    assert abs(res.probe - _jax_probe(7, np.float64)) <= 1e-12 * abs(
        res.probe)
    assert [s.split(":")[0] for s in lines] == ["total-CV first call",
                                                "warm total CV (single "
                                                "barrier)"]


@pytest.mark.parametrize("impl, port", [("pallas", "cuda"),
                                        ("xla", "torch")])
def test_jax_impl_names_raise(monkeypatch, capsys, impl, port):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BENCH_IMPL", impl)
    with pytest.raises(ValueError, match=f"counterpart of '{impl}' is "
                                         f"'{port}'"):
        B.main()
    with pytest.raises(ValueError, match="auto|cuda|torch"):
        B.run(N, K, M, impl=impl, device="cpu")
    assert capsys.readouterr().out == ""


def test_no_card_raises_without_the_cpu_asked_for(monkeypatch, capsys):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("BENCH_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        B.main()
    assert capsys.readouterr().out == ""  # no line, no silent CPU run


WATCHDOG = ("import threading\n"
            "import cvmatrix_tpu_torch.bench as B\n"
            "{stub}"
            "B.main()\n")


def test_watchdog_exits_3_when_the_device_hangs():
    # the device's initialisation never returns
    code = WATCHDOG.format(stub="B.init_device = lambda platform: "
                                "threading.Event().wait()\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=_env(BENCH_DEVICE_TIMEOUT="0.2"))
    assert res.returncode == 3, res.stderr[-2000:]
    assert [json.loads(s) for s in res.stdout.splitlines()] == [{
        "metric": "benchmark_backend_unavailable", "value": 0.0,
        "unit": "folds/s", "vs_baseline": 0.0,
        "package": "cvmatrix_tpu_torch"}]
    assert "did not initialise within" in res.stderr


def test_watchdog_is_disarmed_once_the_device_is_up():
    """Work after the device is up that outlasts the timeout (as a first
    call's kernel build may) ends with its line and exit code 0."""
    stub = ("run = B.run\n"
            "def slow_run(*a, **k):\n"
            "    threading.Event().wait(0.5)  # stands in for the nvcc build\n"
            "    return run(*a, **k)\n"
            "B.run = slow_run\n")
    res = subprocess.run([sys.executable, "-c", WATCHDOG.format(stub=stub)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=_env(BENCH_DEVICE_TIMEOUT="0.1"))
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout)["metric"].startswith("weighted_TTTT_P300")
    assert "did not initialise" not in res.stderr
