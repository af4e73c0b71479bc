"""The port's wide-K and mesh benchmark scripts at a tiny size on the CPU
(gloo for the mesh ones), each against the per-fold engine."""

import json

import numpy as np
import pytest
import torch

from cvmatrix_tpu_torch import CVConfig, Partitioner, fit
from cvmatrix_tpu_torch.benchmarks import mesh_one_chip, mesh_scaling
from cvmatrix_tpu_torch.benchmarks import widek_genomics as WK
from cvmatrix_tpu_torch.core.fold import training_XTX_XTY

TTTT = CVConfig(True, True, True, True, ddof=1, dtype=np.float64)


def test_widek_genomics_against_the_per_fold_engine(tmp_path):
    n, k = 300, 700  # K > N, as at N=5,000, K=20,000
    out = tmp_path / "widek.json"
    assert WK.main(["--device", "cpu", "--n", str(n), "--k", str(k),
                    "--out", str(out)]) == 0
    row = json.loads(out.read_text())
    rng = np.random.default_rng(0)
    X, Y = rng.random((n, k)), rng.random((n, WK.M))
    st = fit(TTTT, X, Y, None, device="cpu")
    _, idx, mask = Partitioner(np.arange(n) % WK.P).padded_batches()
    want = [float(torch.diagonal(training_XTX_XTY(TTTT, st, f)[0][0]).mean())
            for f in idx]
    np.testing.assert_allclose(row["diag_mean"], want, rtol=1e-10)
    assert mask is None and row["xty0_shape"] == [WK.P, k]
    assert row["sweep_vs_engine_diag_abs_d"] < 1e-6
    assert (row["N"], row["K"], row["M"], row["P"]) == (n, k, WK.M, WK.P)
    assert row["launches"] == {}
    assert row["peak_fit_gb"] is None and row["peak_sweep_gb"] is None
    assert row["platform"] == "cpu" and row["folds_per_sec"] > 0


def test_widek_genomics_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        WK.run(40, 60)


def test_mesh_one_chip_against_the_per_fold_engine():
    n, k, m = 600, 20, 3
    rows = mesh_one_chip.run([600, 50], n, k, m, 64, device="cpu")
    rng = np.random.default_rng(42)
    X, Y, w = rng.random((n, k)), rng.random((n, m)), rng.random(n)
    st = fit(TTTT, X, Y, w, device="cpu")
    for row, p in zip(rows, (600, 50)):
        fold0 = Partitioner(np.arange(n) % p).folds_dict[0]
        (xtx, xty), _ = training_XTX_XTY(TTTT, st, fold0)
        want = float(xtx[0, 0] + xty[0, 0])
        assert row["P"] == p and row["batch_size"] == 64
        for key in ("reduce_fold0", "mesh1_fold0"):
            assert abs(row[key] - want) <= 1e-10 * abs(want)
        assert row["mesh1_vs_reduce_max_abs"] <= 1e-10 * abs(want)
        for key in ("single_chip_s", "single_reduce_s", "mesh1_s"):
            assert row[key] > 0
        assert row["mesh1_over_single_reduce"] == pytest.approx(
            row["mesh1_s"] / row["single_reduce_s"])
    assert not torch.distributed.is_initialized()


def test_mesh_scaling_over_gloo_ranks(tmp_path, monkeypatch):
    monkeypatch.setenv("SCALE_N", "500")
    monkeypatch.setenv("SCALE_K", "10")
    monkeypatch.setenv("SCALE_M", "2")
    monkeypatch.setenv("SCALE_P", "200")
    monkeypatch.setenv("SCALE_SIZES", "1,2,4")
    monkeypatch.setenv("SCALE_REPS", "1")
    monkeypatch.setenv("SCALE_ROUNDS", "1")
    out = tmp_path / "scaling.json"
    assert mesh_scaling.main(["--out", str(out), "--device", "cpu"]) == 0
    summary = json.loads(out.read_text())
    rows = summary["rows"]
    assert [r["n_ranks"] for r in rows] == [1, 2, 4]
    assert rows[0]["scaling_efficiency"] == 1.0
    for r in rows:
        assert r["max_abs_err_vs_engine"] <= 1e-8 * 1e3
        assert r["per_rank_folds_per_sec"] == pytest.approx(
            r["folds_per_sec"] / r["n_ranks"])
        assert r["scaling_efficiency"] == pytest.approx(
            r["folds_per_sec"] / rows[0]["folds_per_sec"])
    assert summary["config"]["P"] == 200 and summary["backend"] == "gloo"
    assert summary["platform"] == "cpu"


@pytest.mark.parametrize("platform", [None, "cuda"])
def test_mesh_scaling_needs_the_cpu_asked_for(tmp_path, monkeypatch,
                                              platform):
    # the host proxy runs only when the caller asks for the CPU; the
    # BENCH_PLATFORM=cpu request is the flag's equal
    if platform is None:
        monkeypatch.delenv("BENCH_PLATFORM", raising=False)
    else:
        monkeypatch.setenv("BENCH_PLATFORM", platform)
    out = tmp_path / "scaling.json"
    with pytest.raises(RuntimeError, match="--device cpu"):
        mesh_scaling.main(["--out", str(out)])
    assert not out.exists()
    monkeypatch.setenv("BENCH_PLATFORM", "cpu")
    monkeypatch.setattr(mesh_scaling, "run",
                        lambda *a: {"platform": "cpu", "rows": []})
    assert mesh_scaling.main(["--out", str(out)]) == 0
    assert json.loads(out.read_text())["platform"] == "cpu"


def test_mesh_scaling_engine_reductions_are_traces():
    red = mesh_scaling.engine_reductions(50, 6, 2, 20)
    rng = np.random.default_rng(0)
    X, Y, w = rng.random((50, 6)), rng.random((50, 2)), rng.random(50)
    st = fit(TTTT, X, Y, w, device="cpu")
    want = [float(torch.trace(training_XTX_XTY(TTTT, st, np.array([i]))[0][0]))
            for i in range(20)]
    np.testing.assert_allclose(red, want, rtol=1e-12)
