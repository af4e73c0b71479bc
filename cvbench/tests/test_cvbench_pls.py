"""The PLS cell and the 1,000-fold cell on the CPU at a tiny size, through the
program's plain twins (``run.run_cell(device="cpu", override=...)``), the
faults and the float32 control that have to come out as not correct, and the
two PLS readers of a traced record."""

import json
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cvbench import calibrate_pls, pls_costs, reference_pls, run, tracing
from cvbench.metrics import pls_ms, pls_roofline_pct

SEED = 2 ** 31 + 123
TINY = {
    "ikpls_n100k.loocv": dict(N=300, K=12, M=3, P=300, batch_size=64,
                              n_components=5),
    "upstream_n100k.kfold1000": dict(N=300, K=12, M=3, P=30, batch_size=8),
}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(cell, trace=False, seconds=0.3, **kw):
    res = run.run_cell(cell, SEED, seconds, trace, device="cpu",
                       override=TINY[cell], **kw)
    json.dumps(res)
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


def test_pls_cell_checks_pls_rel_err():
    res = _run("ikpls_n100k.loocv")
    assert set(res["checks"]) == {"fit_rel_err", "pls_rel_err"}
    assert res["checks"]["pls_rel_err"]["value"] < 1e-11


# ---- faults: each has to turn `correct` false -------------------------- #

def _patch_press(monkeypatch, change):
    from cvmatrix_tpu_torch.models import pls

    orig = pls.cross_validate_pls

    def f(*a, **k):
        return change(orig(*a, **k))
    monkeypatch.setattr(pls, "cross_validate_pls", f)


def _dropped(press):
    """The last component left out: its PRESS is the one before."""
    press[:, -1] = press[:, -2].clone()
    return press


def _previous(press):
    """Every component count reads the PRESS of the count before."""
    press[:, 1:] = press[:, :-1].clone()
    return press


@pytest.mark.parametrize("fault", [_dropped, _previous])
def test_fault_is_not_correct(monkeypatch, fault):
    _patch_press(monkeypatch, fault)
    res = _run("ikpls_n100k.loocv", seconds=0.5)
    assert res["attempted"] > 1
    assert not res["correct"] and res["failed"] > 0
    assert float(res["checks"]["pls_rel_err"]["value"]) > (
        res["checks"]["pls_rel_err"]["limit"])


def _ref32_fit(config, X, Y, w):
    from cvbench import reference

    r = reference.fit_rows(X, Y, w, np.arange(X.shape[1]),
                           dtype=torch.float32)
    return SimpleNamespace(X=X, Y=Y, w=w, **r)


def test_float32_control_is_not_correct(monkeypatch):
    """The reference in float32 in the program's place reads over both
    limits."""
    from cvmatrix_tpu_torch.models import pls

    cfg = {**run.load_json("configs", "ikpls_n100k_k500_m10_a20"),
           **TINY["ikpls_n100k.loocv"]}

    def ref32(config, state, idx, mask=None, **kw):
        return torch.stack([reference_pls.fold_press(
            state.X, state.Y, state.w,
            row if mask is None else row[mask[f] == 1], cfg,
            dtype=torch.float32) for f, row in enumerate(idx)])

    monkeypatch.setattr(pls, "cross_validate_pls", ref32)
    res = _run("ikpls_n100k.loocv", seconds=0.5, fit_fn=_ref32_fit)
    assert res["attempted"] > 0 and not res["correct"]
    for n, c in res["checks"].items():
        assert float(c["value"]) > c["limit"], n


def test_calibration_control_reads_over_the_limit():
    limit = run.load_json("workloads", "ikpls_n100k.loocv")["limits"]
    worst = calibrate_pls.control("ikpls_n100k.loocv", 7, 2, device="cpu",
                                  override=TINY["ikpls_n100k.loocv"])
    assert set(worst) == {"fit_rel_err", "pls_rel_err"}
    for n, v in worst.items():
        assert v > limit[n], n


# ---- the readers ----------------------------------------------------------- #

def _record(ops):
    """A record of one traced total from 0 to 10 s, the folds' span from
    100 us, with device ``ops`` ``(start, end, name)`` in us."""
    return tracing.Record([{"total": (0.0, 1e7), "folds": (100.0, 1e7)}],
                          sorted(ops), [], {"fit": 0.0, "folds": 0.0}, "pls")


def test_readers_read_none_without_the_kernel(monkeypatch):
    res = _run("ikpls_n100k.loocv", trace=True)  # no device operations
    assert "pls_ms" not in res["metrics"]
    assert "pls_roofline_pct" not in res["metrics"]
    monkeypatch.setitem(sys.modules, "cvbench.entries.pls",
                        SimpleNamespace(LEAST_PLS_S=1e-4))
    rec = _record([(150.0, 400.0, "loocv_tile_kernel"),
                   (10.0, 90.0, "ikpls2_kernel")])  # before the folds' span
    assert pls_ms.read(rec) is None
    assert pls_roofline_pct.read(rec) is None


def test_roofline_without_the_entry_reads_none(monkeypatch):
    monkeypatch.delitem(sys.modules, "cvbench.entries.pls", raising=False)
    rec = _record([(150.0, 400.0, "void (anonymous namespace)::ikpls2_kernel")])
    assert pls_ms.read(rec) == pytest.approx(0.25)
    assert pls_roofline_pct.read(rec) is None


def test_share_of_a_design_at_the_least_work_stays_at_most_100(monkeypatch):
    """A synthetic traced total whose ``ikpls2`` operations take exactly the
    full-size cell's least time reads 100%, a slower one less; the count
    leaves the fold matrices out, so a design that never forms them is not
    held above it."""
    cfg = run.load_json("configs", "ikpls_n100k_k500_m10_a20")
    shapes = [(cfg["N"], 1)]
    least, bound = pls_costs.least_seconds(cfg, shapes)
    assert bound == "flops"
    flops = pls_costs.pls_cost(shapes, 500, 10, 20, 8, True)[1]
    assert flops == 100_000 * 20 * (2 * 500 ** 2 + 6 * 500 * 10)
    monkeypatch.setitem(sys.modules, "cvbench.entries.pls",
                        SimpleNamespace(LEAST_PLS_S=least))
    us = least * 1e6
    at_least = _record([(200.0, 200.0 + us / 2, "ikpls2_kernel"),
                        (300.0 + us / 2, 300.0 + us, "ikpls2_kernel")])
    assert pls_ms.read(at_least) == pytest.approx(least * 1e3)
    assert pls_roofline_pct.read(at_least) == pytest.approx(100.0)
    slower = _record([(200.0, 200.0 + 3 * us, "ikpls2_kernel")])
    assert 0 < pls_roofline_pct.read(slower) <= 100 / 3 + 1e-9
