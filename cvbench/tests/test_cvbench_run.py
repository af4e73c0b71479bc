"""A whole run of each cell on the CPU at a tiny size, through the
program's plain twins (``run.run_cell(device="cpu", override=...)``; the
benchmark's command needs the card), and the faults and the control that
have to come out as not correct."""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cvbench import reference, run

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 99
TINY = {
    "upstream_n100k.loocv": dict(N=300, K=12, M=3, P=300, batch_size=64),
    "widek_n5k.kfold10": dict(N=120, K=1100, M=1, P=10, batch_size=1),
    "upstream_n100k.kfold10000": dict(N=300, K=12, M=3, P=30, batch_size=8),
    "upstream_n100k.loocv_reduce": dict(N=300, K=12, M=3, P=300,
                                        batch_size=64),
}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(cell, trace=False, seconds=0.3, **kw):
    res = run.run_cell(cell, SEED, seconds, trace, device="cpu",
                       override=TINY[cell], **kw)
    json.dumps(res)  # the line is JSON
    return res


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", list(TINY))
def test_cell_runs_correct(cell, trace):
    res = _run(cell, trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    kinds = "per_layer" if trace else "end_to_end"
    allowed = {m["name"] for m in run.cell_metrics(cell, kinds)}
    assert set(res["metrics"]) <= allowed
    if not trace:
        assert set(res["metrics"]) == allowed
    for n, c in res["checks"].items():
        assert c["value"] <= c["limit"], n


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cell", ["upstream_n100k.kfold10000",
                                  "upstream_n100k.loocv_reduce"])
def test_unequal_folds_run_correct(cell, masked):
    """P=7 over 300 rows: folds of 43 and 42 rows, as two buckets or as one
    padded masked batch."""
    res = run.run_cell(cell, SEED, 0.3, False, device="cpu", override=dict(
        N=300, K=12, M=3, P=7, batch_size=3, masked=masked))
    assert res["correct"] and res["attempted"] > 0


# ---- faults: each has to turn `correct` false -------------------------- #

def _patched(monkeypatch, module, name, wrap):
    orig = getattr(module, name)
    monkeypatch.setattr(module, name, wrap(orig))


def _stale(orig):
    """Every call after the first returns the first call's result."""
    first = []

    def f(*a, **k):
        if not first:
            first.append(orig(*a, **k))
        return first[0]
    return f


def _half(out):
    """The second half of the folds' outputs copies the first half's."""
    h = out.shape[0] // 2
    if h:
        out[h:2 * h] = out[:h].clone()
    return out


def _batched_half(orig):
    def f(*a, **k):
        (xtx, xty), stats = orig(*a, **k)
        return (_half(xtx), _half(xty)), stats
    return f


def _batched_altered(orig):
    def f(*a, **k):
        (xtx, xty), stats = orig(*a, **k)
        xtx[:, 0, 0] += 1e-7 * xtx.abs().amax()
        return (xtx, xty), stats
    return f


def _reduce_half(orig):
    return lambda *a, **k: _half(orig(*a, **k))


def _reduce_altered(orig):
    def f(*a, **k):
        out = orig(*a, **k)
        out[:, 0] += 1e-7 * out.abs().amax()
        return out
    return f


@pytest.mark.parametrize("fault", ["stale", "half", "altered", "stale_fit"])
@pytest.mark.parametrize("cell", ["upstream_n100k.loocv",
                                  "upstream_n100k.loocv_reduce"])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    from cvmatrix_tpu_torch.core import batch
    from cvmatrix_tpu_torch.models import sweep

    kw = {}
    target = ((batch, "training_matrices_batched") if "reduce" not in cell
              else (sweep, "cross_validate_reduce"))
    wraps = {"stale": _stale,
             "half": _batched_half if "reduce" not in cell else _reduce_half,
             "altered": (_batched_altered if "reduce" not in cell
                         else _reduce_altered)}
    if fault == "stale_fit":
        from cvmatrix_tpu_torch.core.fit import fit
        kw["fit_fn"] = _stale(fit)
    else:
        _patched(monkeypatch, *target, wraps[fault])
    res = _run(cell, seconds=0.5, **kw)
    assert res["attempted"] > 1
    assert not res["correct"] and res["failed"] > 0


# ---- the control: the reference in float32 in the program's place ------ #

def _cfg(config):
    return dict(center_X=config.center_X, center_Y=config.center_Y,
                scale_X=config.scale_X, scale_Y=config.scale_Y,
                ddof=config.ddof, dtype=np.dtype(config.dtype).name)


def _ref32_fit(config, X, Y, w):
    r = reference.fit_rows(X, Y, w, np.arange(X.shape[1]),
                           dtype=torch.float32)
    return SimpleNamespace(X=X, Y=Y, w=w, **r)


def _ref32_folds(config, state, idx, mask):
    outs = []
    for f in range(idx.shape[0]):
        val = idx[f] if mask is None else idx[f][mask[f] == 1]
        outs.append(reference.fold(state.X, state.Y, state.w, val,
                                   _cfg(config), dtype=torch.float32))
    return outs


def _ref32_batched(config, state, idx, mask=None, **kw):
    outs = _ref32_folds(config, state, idx, mask)
    stats = [torch.stack([o[2][i] for o in outs]) for i in range(4)]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs])), stats


def _ref32_reduce(config, state, idx, mask=None, *, reduce_fn, **kw):
    return torch.stack([reduce_fn((xtx, xty), s) for xtx, xty, s in
                        _ref32_folds(config, state, idx, mask)])


@pytest.mark.parametrize("cell", ["upstream_n100k.loocv",
                                  "upstream_n100k.loocv_reduce"])
def test_float32_control_is_not_correct(monkeypatch, cell):
    from cvmatrix_tpu_torch.core import batch
    from cvmatrix_tpu_torch.models import sweep

    monkeypatch.setattr(batch, "training_matrices_batched", _ref32_batched)
    monkeypatch.setattr(sweep, "cross_validate_reduce", _ref32_reduce)
    res = _run(cell, seconds=0.5, fit_fn=_ref32_fit)
    assert res["attempted"] > 0 and not res["correct"]
    for n, c in res["checks"].items():
        assert float(c["value"]) > c["limit"], n


# ---- the process ---------------------------------------------------------- #

def test_no_jax_loaded_after_a_run():
    code = ("import json, sys; from cvbench import run; "
            f"run.run_cell('upstream_n100k.loocv', 5, 0.2, True, "
            f"device='cpu', override={TINY['upstream_n100k.loocv']!r}); "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules}"
            " & set(run.FORBIDDEN))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_command_without_a_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the command would run the cell")
    env = {k: v for k, v in os.environ.items() if k != "BENCH_RUN"}
    out = subprocess.run(
        [sys.executable, "cvbench/run.py", "--workload",
         "upstream_n100k.loocv", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
