"""The wide-K PLS cell on the CPU at a tiny size, through the program's plain
twins (``run.run_cell(device="cpu", override=...)``), with ``ops.pls.MAX_K`` lowered so that the PLS cell's
buckets take the wide route as they do at K = 20,000 on the card; the float32
control that has to come out as not correct; and the two wide readers of a
traced record."""

import json
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cvbench import calibrate_pls, pls_costs, reference_pls, run, tracing
from cvbench.metrics import pls_wide_ms, pls_wide_roofline_pct

SEED = 2 ** 31 + 321
TINY = {
    "ikpls_widek_n5k.kfold10": dict(N=200, K=40, M=1, P=10, batch_size=2,
                                    n_components=5),
}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture
def wide(monkeypatch):
    """K = 40 over ``MAX_K``: the wide route, as K = 20,000 takes it."""
    from cvmatrix_tpu_torch.ops import pls

    monkeypatch.setattr(pls, "MAX_K", 39)
    pls.reset_launch_counts()
    return pls


def _run(cell, trace=False, seconds=0.3, **kw):
    res = run.run_cell(cell, SEED, seconds, trace, device="cpu",
                       override=TINY[cell], **kw)
    json.dumps(res)
    return res


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", list(TINY))
def test_cell_runs_correct(wide, cell, trace):
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
    # every fold of every total on the wide route, 5 chunks of 2
    assert wide.fold_components("wide") == (res["attempted"] + 1) * 10 * 5
    assert wide.fold_components("matrices") == 0


def test_pls_cell_checks_pls_rel_err(wide):
    res = _run("ikpls_widek_n5k.kfold10")
    assert set(res["checks"]) == {"fit_rel_err", "pls_rel_err"}
    assert res["checks"]["pls_rel_err"]["value"] < 1e-11


def test_cell_is_the_deployment():
    """The configuration holds config 4's data with 20 components and the
    cell its 10 folds in chunks of 2."""
    cfg = run.load_json("configs", "ikpls_widek_n5k_k20k_m1_a20")
    data = run.load_json("configs", "widek_n5k_k20k_m1")
    for key in ("N", "K", "M", "dtype", "center_X", "center_Y", "scale_X",
                "scale_Y", "ddof", "weighted", "reduced"):
        assert cfg[key] == data[key], key
    assert cfg["n_components"] == 20
    cell = run.load_json("workloads", "ikpls_widek_n5k.kfold10")
    assert (cell["entry"], cell["P"], cell["batch_size"]) == ("pls", 10, 2)


def _ref32_fit(config, X, Y, w):
    from cvbench import reference

    r = reference.fit_rows(X, Y, w, np.arange(X.shape[1]),
                           dtype=torch.float32)
    return SimpleNamespace(X=X, Y=Y, w=w, **r)


def test_float32_control_is_not_correct(wide, monkeypatch):
    """The reference in float32 in the program's place reads over both
    limits."""
    from cvmatrix_tpu_torch.models import pls

    cfg = {**run.load_json("configs", "ikpls_widek_n5k_k20k_m1_a20"),
           **TINY["ikpls_widek_n5k.kfold10"]}

    def ref32(config, state, idx, mask=None, **kw):
        return torch.stack([reference_pls.fold_press(
            state.X, state.Y, state.w, row, cfg, dtype=torch.float32)
            for row in idx])

    monkeypatch.setattr(pls, "cross_validate_pls", ref32)
    res = _run("ikpls_widek_n5k.kfold10", seconds=0.5, fit_fn=_ref32_fit)
    assert res["attempted"] > 0 and not res["correct"]
    for n, c in res["checks"].items():
        assert float(c["value"]) > c["limit"], n


def test_calibration_control_reads_over_the_limit():
    limit = run.load_json("workloads", "ikpls_widek_n5k.kfold10")["limits"]
    worst = calibrate_pls.control("ikpls_widek_n5k.kfold10", 7, 2,
                                  device="cpu",
                                  override=TINY["ikpls_widek_n5k.kfold10"])
    assert set(worst) == {"fit_rel_err", "pls_rel_err"}
    for n, v in worst.items():
        assert v > limit[n], n


# ---- the readers ----------------------------------------------------------- #

def _record(ops):
    """A record of one traced total from 0 to 10 s, the folds' span from
    100 us, with device ``ops`` ``(start, end, name)`` in us."""
    return tracing.Record([{"total": (0.0, 1e7), "folds": (100.0, 1e7)}],
                          sorted(ops), [], {"fit": 0.0, "folds": 0.0}, "pls")


def test_readers_read_none_without_the_wide_kernels(monkeypatch):
    """The parent's program has no ``ikpls2_wide`` kernel: nothing to read,
    and no error (``ikpls2`` and the fold kernels do not count)."""
    monkeypatch.setitem(sys.modules, "cvbench.entries.pls",
                        SimpleNamespace(LEAST_PLS_S=1e-4))
    rec = _record([(150.0, 400.0, "void (anonymous namespace)::ikpls2_kernel"),
                   (500.0, 900.0, "fold_epilogue_kernel"),
                   (10.0, 90.0, "ikpls2_wide_step_kernel")])  # before folds
    assert pls_wide_ms.read(rec) is None
    assert pls_wide_roofline_pct.read(rec) is None


def test_roofline_without_the_entry_reads_none(monkeypatch):
    monkeypatch.delitem(sys.modules, "cvbench.entries.pls", raising=False)
    rec = _record([(150.0, 400.0,
                    "void (anonymous namespace)::ikpls2_wide_product_kernel")])
    assert pls_wide_ms.read(rec) == pytest.approx(0.25)
    assert pls_wide_roofline_pct.read(rec) is None


def test_share_at_the_least_work_stays_at_most_100(monkeypatch):
    """The full-size cell's least PLS time is 2.39 ms, bounded by FLOPs; a
    traced total whose wide operations take exactly that reads 100%, a
    slower one less, and the other operations of the folds' span count
    nothing."""
    cfg = run.load_json("configs", "ikpls_widek_n5k_k20k_m1_a20")
    shapes = [(10, 500)]
    least, bound = pls_costs.least_seconds(cfg, shapes)
    assert bound == "flops" and least == pytest.approx(2.388e-3, rel=1e-3)
    monkeypatch.setitem(sys.modules, "cvbench.entries.pls",
                        SimpleNamespace(LEAST_PLS_S=least))
    us = least * 1e6
    at_least = _record([(200.0, 200.0 + us / 2, "ikpls2_wide_product_kernel"),
                        (300.0 + us / 2, 300.0 + us, "ikpls2_wide_step_kernel"),
                        (400.0 + us, 900.0 + us, "fold_epilogue_kernel")])
    assert pls_wide_ms.read(at_least) == pytest.approx(least * 1e3)
    assert pls_wide_roofline_pct.read(at_least) == pytest.approx(100.0)
    slower = _record([(200.0, 200.0 + 3 * us, "ikpls2_wide_product_kernel")])
    assert 0 < pls_wide_roofline_pct.read(slower) <= 100 / 3 + 1e-9
