"""The port's spans (``cvmatrix_tpu_torch.utils.profiling.span``) on the CPU.

Each case runs one entry under ``torch.profiler`` (CPU activity) and reads
the Chrome trace back: the program's spans (``user_annotation`` events
named ``cvmatrix_tpu_torch.*``) are those the code opens, as many as the
table below takes from the code; no span lies inside another of its name;
the outputs are bitwise those of a run without a profiler; and with no
profiler recording, no ``record_function`` is entered. The batched entry
goes through every route the CPU twins reach, one call a case (one chunk:
one route span), with the same span counts as on the card: the twins take
no copy of rows that are on the state's device already. Every copy of fold
rows or a mask is one ``to_device`` call that blocks on nothing
(``h2d_counts``), as many as the ``h2d`` spans.
"""

import collections
import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import cvmatrix_tpu_torch as T
from cvmatrix_tpu_torch.core import batch as TB
from cvmatrix_tpu_torch.models import sweep as TS
from cvmatrix_tpu_torch.utils import profiling as P

N = 120


def _data(k, m, n=N, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, k))
    Y = rng.uniform(size=(n, m))
    w = rng.uniform(0.5, 1.5, size=(n, 1))
    return X, Y, w


def _state(k=6, m=3, dtype=np.float64, mode="auto", n=N):
    cfg = T.CVConfig(True, True, True, True, ddof=1, dtype=dtype,
                     matmul_mode=mode)
    X, Y, w = _data(k, m, n)
    return cfg, T.fit(cfg, X, Y, w, device="cpu")


def _folds(n_folds, n_l, n=N, masked=False):
    """``n_folds`` disjoint folds of ``n_l`` rows, in a shuffled order; a
    mask that drops each fold's last row where ``masked``."""
    rows = np.random.default_rng(1).permutation(n)[:n_folds * n_l]
    idx = rows.reshape(n_folds, n_l)
    mask = None
    if masked:
        mask = np.ones((n_folds, n_l))
        mask[:, -1] = 0.0
    return idx, mask


# --------------------------------------------------------------------------- #
# Cases: (entry, expected spans per name, route spans)                        #
# --------------------------------------------------------------------------- #

# per route of training_matrices_batched, one call: (h2d, sources, stats)
# with every centre/scale flag on and weights; a mask adds one h2d
ROUTE_SPANS = {
    # prepare_loocv_sources' rows (the kernel runs on them); sources; no
    # statistics span (the kernel stores them)
    "loocv": (1, 1, 0),
    "loocv_x2": (1, 1, 0),
    "loocv_sym": (1, 1, 0),
    # _rows_mask's rows; prepare_fold_operands; stats_from_blocks
    "packed": (1, 1, 1),
    "packed_f32": (1, 1, 1),
    # _rows_mask's rows; the v3 sources; one _summed_stats for the
    # statistics and the sources' Y side
    "v3": (1, 1, 1),
    "v3_sym": (1, 1, 1),
    # the call's rows, mask and total; _summed_stats (fused) or
    # stats_from_blocks (gathered)
    "ozaki_df64": (1, 1, 1),
    "epilogue": (1, 1, 1),
    "downdate_f32": (1, 1, 1),
}

# route -> (k, m, dtype, matmul_mode, n_folds, n_l, n, policy knobs)
ROUTE_CASES = {
    "loocv": (6, 3, np.float64, "auto", 8, 1, N, {}),
    "loocv_x2": (6, 3, np.float64, "auto", 8, 1, N, {"df64x2": True}),
    "loocv_sym": (130, 3, np.float64, "auto", 8, 1, 160,
                  {"sym_loocv": True}),
    "packed": (6, 3, np.float64, "auto", 6, 4, N, {}),
    "packed_f32": (6, 3, np.float32, "auto", 6, 4, N, {}),
    "v3": (6, 3, np.float64, "auto", 4, 12, N, {}),
    "v3_sym": (130, 3, np.float64, "auto", 4, 12, 160, {"sym_loocv": True}),
    "ozaki_df64": (6, 3, np.float64, "auto", 2, 500, 1000, {}),
    "epilogue": (6, 3, np.float64, "native", 2, 40, N, {}),
    "downdate_f32": (6, 3, np.float32, "auto", 2, 40, N, {}),
}
MASKABLE = ("packed", "v3", "epilogue", "downdate_f32")


@pytest.fixture
def policy_restored():
    before = T.policy()
    yield
    T.set_routing(**dataclasses.asdict(before))


def _batched_case(route, masked):
    k, m, dtype, mode, n_folds, n_l, n, knobs = ROUTE_CASES[route]
    cfg, st = _state(k, m, dtype, mode, n)
    idx, mask = _folds(n_folds, n_l, n, masked)
    h2d, sources, stats = ROUTE_SPANS[route]
    want = {P.ROUTE + route: 1, P.H2D: h2d + masked, P.SOURCES: sources,
            P.STATS: stats}
    want = {name: n for name, n in want.items() if n}

    def run():
        return TB.training_matrices_batched(cfg, st, idx, mask)
    return knobs, (cfg, st, idx.shape[1], mask is not None, n_folds), run, \
        want


def _colsum(mats, stats):
    xtx, xty = mats
    return xtx.sum(dim=0) + xty.sum() + stats[0].sum()


def _reduce_case(kind):
    """``cross_validate_reduce`` through each body: the hoisted LOOCV,
    packed and v3 plans and the generic one (``impl="torch"``)."""
    n_l, impl, bs = {"loocv": (1, "auto", 7), "packed": (4, "auto", 4),
                     "v3": (12, "auto", 3), "generic": (4, "torch", 4)}[kind]
    cfg, st = _state()
    n_folds = 20 if n_l == 1 else 9
    idx, _ = _folds(n_folds, n_l)
    chunks = -(-n_folds // min(bs, n_folds))
    want = {P.SWEEP + "cross_validate_reduce": 1, P.REDUCE_FN: chunks}
    if kind == "loocv":
        # sources and their rows once, which every chunk's kernel reads (the
        # kernel stores the statistics: no statistics span)
        want.update({P.SOURCES: 1, P.H2D: 1})
    elif kind == "packed":
        want.update({P.SOURCES: 1, P.H2D: 1, P.STATS: 1})
    elif kind == "v3":
        # one _summed_stats for the statistics and the sources' Y side
        want.update({P.SOURCES: 1, P.H2D: 1, P.STATS: 1})
    else:
        # the total once, then training_matrices_batched per chunk
        want.update({P.SOURCES: 1 + chunks, P.H2D: chunks,
                     P.STATS: chunks, P.ROUTE + "packed": chunks})

    def run():
        return TS.cross_validate_reduce(cfg, st, idx, reduce_fn=_colsum,
                                        batch_size=bs, impl=impl)
    return run, want


def _materialize_case(kind):
    """``materialize_sweep`` through its LOOCV, packed, v3 and large-fold
    plans, in chunks of 4 folds."""
    n_l, n_folds, mode = {"loocv": (1, 10, "auto"), "packed": (4, 10, "auto"),
                          "v3": (12, 9, "auto"),
                          "epilogue": (40, 3, "native")}[kind]
    cfg, st = _state(mode=mode)
    idx, _ = _folds(n_folds, n_l)
    chunks = -(-n_folds // 4)
    # one copy of the rows: the LOOCV sources' or the call's
    want = {P.SWEEP + "materialize_sweep": 1, P.SOURCES: 1, P.H2D: 1}
    if kind in ("packed", "v3"):
        # v3: the Y side's statistics inside prepare_ozaki_sources
        want[P.STATS] = 1
    elif kind == "epilogue":
        want[P.STATS] = chunks

    def run():
        return TS.materialize_sweep(cfg, st, idx, batch_size=4)
    return run, want


def _fit_case():
    cfg = T.CVConfig(True, True, True, True, ddof=1)
    X, Y, w = _data(6, 3)

    def run():
        st = T.fit(cfg, X, Y, w, device="cpu")
        return (st.XTX, st.XTY, st.sum_X, st.sum_sq_Y, st.sum_w)
    return run, {P.FIT: 1}


BATCHED = [(r, False) for r in ROUTE_CASES] + [(r, True) for r in MASKABLE]
ENTRIES = ([f"reduce-{k}" for k in ("loocv", "packed", "v3", "generic")]
           + [f"materialize-{k}" for k in ("loocv", "packed", "v3",
                                             "epilogue")]
           + ["fit"])
CASES = [f"batched-{r}{'-masked' if m else ''}" for r, m in BATCHED] + ENTRIES


def _case(name):
    """``(run, want)`` of a case, with its routing knobs set."""
    kind, _, rest = name.partition("-")
    if kind == "batched":
        route = rest.removesuffix("-masked")
        knobs, (cfg, st, n_l, masked, n_folds), run, want = _batched_case(
            route, rest.endswith("-masked"))
        T.set_routing(**knobs)
        assert TB.route_kernel(cfg, st, n_l, True, True, masked,
                               n_folds=n_folds) == route
        return run, want
    if kind == "reduce":
        return _reduce_case(rest)
    if kind == "materialize":
        return _materialize_case(rest)
    return _fit_case()


def _program_spans(run, tmp_path):
    """``run()`` under the profiler -> (its output, the program's spans
    ``(start, end, name)`` sorted by start)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation"
        and e.get("name", "").startswith(P.PREFIX))
    return out, spans


@pytest.mark.parametrize("name", CASES)
def test_spans_are_those_of_the_code(name, tmp_path, policy_restored):
    run, want = _case(name)
    _, spans = _program_spans(run, tmp_path)
    got = collections.Counter(n for _, _, n in spans)
    assert dict(got) == want


@pytest.mark.parametrize("name", CASES)
def test_no_span_nests_in_its_own_name(name, tmp_path, policy_restored):
    run, _ = _case(name)
    _, spans = _program_spans(run, tmp_path)
    assert spans
    end = {}
    for s, e, n in spans:
        assert s >= end.get(n, float("-inf")), (n, s, end[n])
        end[n] = e


@pytest.mark.parametrize("name", CASES)
def test_outputs_bitwise_equal_under_the_profiler(name, tmp_path,
                                                  policy_restored):
    run, _ = _case(name)
    plain = pytree.tree_leaves(run())
    traced, _ = _program_spans(run, tmp_path)
    traced = pytree.tree_leaves(traced)
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("name", CASES)
def test_no_record_function_without_a_profiler(name, monkeypatch,
                                               policy_restored):
    run, _ = _case(name)

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    run()
    assert P.span(P.H2D) is P.span(P.STATS)


def _pls_case(kind):
    """``cross_validate_pls``: the operator route's rows copied once, or
    the reduce sweep's packed plan and its validation rows, one copy
    each."""
    n_l, copies = {"loocv": (1, 1), "kfold": (4, 2)}[kind]
    cfg, st = _state()
    idx, _ = _folds(12, n_l)

    def run():
        return T.cross_validate_pls(cfg, st, idx, n_components=2,
                                    batch_size=5)
    return run, {P.H2D: copies}


@pytest.mark.parametrize("name", CASES + ["pls-loocv", "pls-kfold"])
def test_h2d_copies_never_block(name, policy_restored):
    """Every copy of fold rows or a mask an entry makes goes through
    ``to_device``, as many as its ``h2d`` spans, and none blocks."""
    kind, _, rest = name.partition("-")
    run, want = _pls_case(rest) if kind == "pls" else _case(name)
    P.reset_h2d_counts()
    run()
    assert P.h2d_counts() == {"blocking": 0,
                              "non_blocking": want.get(P.H2D, 0)}


def test_route_spans_name_every_route():
    """The route spans' names are the routes of ``TPU_KERNELS``: the
    batched cases above reach each one."""
    assert set(ROUTE_SPANS) == set(ROUTE_CASES) == set(TB.TPU_KERNELS)


def test_to_device_spans_host_tensors_only(tmp_path):
    """``to_device`` opens its span and counts a copy where the tensor is
    on the host, and returns what ``Tensor.to`` returns."""
    t = torch.arange(5)

    def run():
        a = P.to_device(t, "cpu", copy=True)
        b = P.to_device(torch.zeros(2, device="meta"), "meta")
        return a, b

    P.reset_h2d_counts()
    (a, b), spans = _program_spans(run, tmp_path)
    assert [n for _, _, n in spans] == [P.H2D]
    assert P.h2d_counts() == {"blocking": 0, "non_blocking": 1}
    assert torch.equal(a, t) and a.data_ptr() != t.data_ptr()
    assert b.device.type == "meta"


def test_wide_route_opens_its_span_a_solve(monkeypatch, tmp_path):
    """The wide route on formed matrices (``ops.pls.MAX_K`` lowered below
    K = 6, ``impl="torch"``, which alone reaches it through the sweep):
    one ``ops.pls.ikpls2_wide`` span a chunk's solve, inside that chunk's
    solve span, and P x A fold-components on the wide route, none on
    another."""
    from cvmatrix_tpu_torch.ops import pls as OP

    monkeypatch.setattr(OP, "MAX_K", 5)
    cfg, st = _state()
    idx, _ = _folds(6, 4)
    OP.reset_launch_counts()
    _, spans = _program_spans(lambda: T.cross_validate_pls(
        cfg, st, idx, n_components=2, batch_size=3, impl="torch"), tmp_path)
    got = collections.Counter(n for _, _, n in spans)
    assert got[P.PLS_WIDE] == 2 and got[P.PLS_SOLVE] == 2
    solves = [(s, e) for s, e, n in spans if n == P.PLS_SOLVE]
    for s, e, n in spans:
        if n == P.PLS_WIDE:
            assert any(s0 <= s and e <= e0 for s0, e0 in solves)
    assert OP.fold_components("wide") == 6 * 2
    assert OP.fold_components() == 6 * 2


@pytest.mark.parametrize("masked", [False, True])
def test_wide_operator_route_opens_its_span_a_chunk(monkeypatch, tmp_path,
                                                    masked):
    """The wide operator route (``ops.pls.MAX_K`` lowered below K = 6,
    "auto"): one ``ops.pls.ikpls2_wide_op`` span a chunk, inside that
    chunk's ``models.pls.solve`` span, no reduce sweep and no formed
    route's span; the rows (and the mask) copied once a call; P x A
    fold-components on that route, none on another."""
    from cvmatrix_tpu_torch.ops import pls as OP

    monkeypatch.setattr(OP, "MAX_K", 5)
    cfg, st = _state()
    idx, mask = _folds(7, 4, masked=masked)
    OP.reset_launch_counts()
    _, spans = _program_spans(lambda: T.cross_validate_pls(
        cfg, st, idx, mask, n_components=2, batch_size=3), tmp_path)
    got = collections.Counter(n for _, _, n in spans)
    assert got == {P.PLS + "cross_validate_pls": 1,
                   P.PLS_ROUTE + "wide_op": 1, P.PLS_SOLVE: 3,
                   P.PLS_WIDE_OP: 3, P.H2D: 2 if masked else 1}
    solves = [(s, e) for s, e, n in spans if n == P.PLS_SOLVE]
    for s, e, n in spans:
        if n == P.PLS_WIDE_OP:
            assert any(s0 <= s and e <= e0 for s0, e0 in solves)
    assert OP.fold_components("wide_op") == 7 * 2
    assert OP.fold_components() == 7 * 2


@pytest.mark.parametrize("route", ["operator", "wide_op", "formed"])
def test_pls_route_span_names_the_route(monkeypatch, tmp_path, route):
    """``cross_validate_pls`` opens one ``models.pls.route.<route>`` span a
    bucket, inside its entry's span, named as ``operator_route`` names the
    route (``formed`` where it names none), and every solve span of the
    bucket inside it: leave-one-out at K = 6 (the operator), K-fold with
    ``ops.pls.MAX_OP_K`` lowered below K = 6 (the wide operator) and
    K-fold at K = 6 (the formed matrices)."""
    from cvmatrix_tpu_torch.models import pls as TP
    from cvmatrix_tpu_torch.ops import pls as OP

    if route == "wide_op":
        monkeypatch.setattr(OP, "MAX_OP_K", 5)
    cfg, st = _state()
    idx, _ = _folds(8, 1 if route == "operator" else 4)
    assert (TP.operator_route(cfg, st, idx, None, "auto")
            or "formed") == route
    _, spans = _program_spans(lambda: T.cross_validate_pls(
        cfg, st, idx, n_components=2, batch_size=3), tmp_path)
    routes = [(s, e, n) for s, e, n in spans if n.startswith(P.PLS_ROUTE)]
    assert [n for _, _, n in routes] == [P.PLS_ROUTE + route]
    (s0, e0, _), = routes
    (s1, e1), = [(s, e) for s, e, n in spans
                 if n == P.PLS + "cross_validate_pls"]
    assert s1 <= s0 and e0 <= e1
    solves = [(s, e) for s, e, n in spans if n == P.PLS_SOLVE]
    assert solves and all(s0 <= s and e <= e0 for s, e in solves)
