"""The soil-spectra PLS2 cell (``lucas_n20k.kfold10``): its configuration is
the deployment and its folds one chunk; on the CPU at a tiny size, through
the program's plain twins (``run.run_cell(device="cpu", override=...)``),
with ``ops.pls.MAX_OP_K`` lowered below K so that the buckets lie between
the two limits and take the wide operator route as K = 4,200 does on the
card; the float32 control that has to come out as not correct; the two
readers of a traced record; and, on a card, the cell itself."""

import json
import sys
from types import SimpleNamespace

import pytest
import torch

from cvbench import calibrate_pls, pls_costs, run, traffic, tracing
from cvbench.metrics import pls_solve_ms, pls_solve_roofline_pct

CELL = "lucas_n20k.kfold10"
CONFIG = "lucas_n20k_k4200_m12_a20"
SEED = 2 ** 31 + 4200
TINY = dict(N=200, K=40, M=12, P=10, n_components=5)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture
def band(monkeypatch):
    """K = 40 over ``MAX_OP_K`` and under ``MAX_K``: the wide operator
    route, as K = 4,200 takes it."""
    from cvmatrix_tpu_torch.ops import pls

    monkeypatch.setattr(pls, "MAX_OP_K", 39)
    assert pls.MAX_K >= TINY["K"]
    pls.reset_launch_counts()
    return pls


def test_config_is_the_deployment():
    """N, K, M and A of the LUCAS library as run, every flag on, nothing
    cut, the source and every assumption written down."""
    cfg = run.load_json("configs", CONFIG)
    assert (cfg["N"], cfg["K"], cfg["M"], cfg["n_components"]) == (
        20_000, 4_200, 12, 20)
    assert cfg["dtype"] == "float64" and cfg["weighted"] and cfg["ddof"] == 1
    assert all(cfg[f] for f in ("center_X", "center_Y", "scale_X",
                                "scale_Y"))
    assert cfg["reduced"] == []
    assert "LUCAS" in cfg["source"] and "4,200 bands" in cfg["source"]
    assert set(cfg["assumed"]) == {"N", "M", "n_components", "folds",
                                   "inputs", "weights", "scoring"}
    bench = run.manifest()
    entry, = [c for c in bench["configs"] if c["name"] == CONFIG]
    assert entry["file"] == f"cvbench/configs/{CONFIG}.json"


def test_cell_is_one_chunk_of_ten_folds():
    """10 interleaved folds of 2,000 rows, all in one chunk at the entry's
    default ``batch_size``, on one chip; both readers list this cell
    alone."""
    cell = run.load_json("workloads", CELL)
    assert (cell["entry"], cell["P"], cell["batch_size"], cell["chips"]) == (
        "pls", 10, 512, 1)
    assert cell["limits"] == {"fit_rel_err": 1e-10, "pls_rel_err": 1e-7}
    cfg = run.load_json("configs", CONFIG)
    folds = traffic.Folds(cfg["N"], cell["P"], cell["batch_size"])
    assert folds.shapes() == [(10, 2_000)]
    assert len(folds.chunks) == 1 and list(folds.chunks[0].folds) == list(
        range(10))
    per_layer = {m["name"]: m for m in run.manifest()["per_layer"]}
    for name in ("pls_solve_ms", "pls_solve_roofline_pct"):
        assert per_layer[name]["workloads"] == [CELL]


def _run(trace=False, seconds=0.3, **kw):
    res = run.run_cell(CELL, SEED, seconds, trace, device="cpu",
                       override=TINY, **kw)
    json.dumps(res)
    return res


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_on_the_wide_operator(band, trace):
    res = _run(trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    kinds = "per_layer" if trace else "end_to_end"
    allowed = {m["name"] for m in run.cell_metrics(CELL, kinds)}
    assert set(res["metrics"]) <= allowed
    if not trace:
        assert set(res["metrics"]) == allowed
    assert set(res["checks"]) == {"fit_rel_err", "pls_rel_err"}
    assert res["checks"]["pls_rel_err"]["value"] < 1e-11
    # every fold of every total (and the warm-up's) in one chunk, no matrix
    totals = res["attempted"] + 1
    assert band.fold_components("wide_op") == totals * 10 * 5
    assert band.fold_components("matrices") == 0
    assert band.fold_components() == totals * 10 * 5


def test_float32_control_reads_over_the_limits():
    limit = run.load_json("workloads", CELL)["limits"]
    worst = calibrate_pls.control(CELL, 7, 2, device="cpu", override=TINY)
    assert set(worst) == {"fit_rel_err", "pls_rel_err"}
    for n, v in worst.items():
        assert v > limit[n], n


# ---- the readers ----------------------------------------------------------- #

def _record(ops):
    """A record of one traced total from 0 to 10 s, the folds' span from
    100 us, with device ``ops`` ``(start, end, name)`` in us."""
    return tracing.Record([{"total": (0.0, 1e7), "folds": (100.0, 1e7)}],
                          sorted(ops), [], {"fit": 0.0, "folds": 0.0}, "pls")


def test_solve_reads_either_route(monkeypatch):
    """The parent forms the fold matrices for ``ikpls2``, the change runs
    the ``ikpls2_wide_op`` kernels: both are the solve; the folds' other
    operations and the fit's are not."""
    monkeypatch.setitem(sys.modules, "cvbench.entries.pls",
                        SimpleNamespace(LEAST_PLS_S=1e-4))
    formed = _record([(150.0, 400.0, "void (anonymous namespace)::"
                                     "ikpls2_kernel(Args)"),
                      (500.0, 900.0, "fold_epilogue_kernel"),
                      (10.0, 90.0, "ikpls2_wide_op_step_kernel")])
    assert pls_solve_ms.read(formed) == pytest.approx(0.25)
    wide = _record([(150.0, 300.0, "ikpls2_wide_op_product_kernel<2>"),
                    (300.0, 400.0, "ikpls2_wide_op_correct_kernel"),
                    (400.0, 450.0, "ikpls2_wide_step_kernel")])
    assert pls_solve_ms.read(wide) == pytest.approx(0.3)
    assert pls_solve_roofline_pct.read(wide) == pytest.approx(
        100 * 0.1 / 0.3)
    assert pls_solve_ms.read(_record([(150.0, 400.0, "gemm")])) is None
    assert pls_solve_roofline_pct.read(_record([])) is None


def test_roofline_without_the_entry_reads_none(monkeypatch):
    monkeypatch.delitem(sys.modules, "cvbench.entries.pls", raising=False)
    rec = _record([(150.0, 400.0, "ikpls2_wide_op_product_kernel<2>")])
    assert pls_solve_ms.read(rec) == pytest.approx(0.25)
    assert pls_solve_roofline_pct.read(rec) is None


def test_share_at_the_least_work_stays_at_most_100(monkeypatch):
    """The full-size cell's least PLS time is 0.243 ms, bounded by bytes
    (the total, 20,000 rows and the PRESS once); a traced total whose solve
    takes exactly that reads 100%, a slower one less."""
    cfg = run.load_json("configs", CONFIG)
    least, bound = pls_costs.least_seconds(cfg, [(10, 2_000)])
    assert bound == "bytes" and least == pytest.approx(2.436e-4, rel=1e-3)
    monkeypatch.setitem(sys.modules, "cvbench.entries.pls",
                        SimpleNamespace(LEAST_PLS_S=least))
    us = least * 1e6
    at_least = _record([(200.0, 200.0 + us, "ikpls2_wide_op_product_kernel")])
    assert pls_solve_roofline_pct.read(at_least) == pytest.approx(100.0)
    slower = _record([(200.0, 200.0 + 4 * us, "ikpls2_wide_op_product")])
    assert 0 < pls_solve_roofline_pct.read(slower) <= 25 + 1e-9


# ---- on the card ------------------------------------------------------------ #

@pytest.mark.cuda
def test_cell_on_the_card_takes_the_wide_operator():
    """The cell at full size on the card: ``correct``, every fold-component
    under "wide_op" and none under "matrices", 3 A + 2 launches a total,
    one ``models.pls.route.wide_op`` span a total, and ``pls_rel_err`` far
    under its limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cvmatrix_tpu_torch.ops import pls
    from cvmatrix_tpu_torch.utils import profiling as P

    pls.reset_launch_counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = run.run_cell(CELL, SEED, 2.0, False)
    assert res["correct"] and res["attempted"] > 0
    totals = res["attempted"] + 1
    assert pls.fold_components("wide_op") == totals * 10 * 20
    assert pls.fold_components("matrices") == 0
    assert pls.launch_counts() == {"ikpls2": 0, "ikpls2_op": 0,
                                   "ikpls2_wide": 0,
                                   "ikpls2_wide_op": totals * 62}
    routes = [e.name for e in prof.events()
              if e.name.startswith(P.PLS_ROUTE)]
    assert routes == [P.PLS_ROUTE + "wide_op"] * totals
    assert res["checks"]["pls_rel_err"]["value"] < 1e-9
