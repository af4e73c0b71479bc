"""``program_spans``: the program's spans read from a trace, on a synthetic
Chrome trace with nested spans and through tiny traced runs on the CPU;
and the harness's own readers, which must read the same with the program's
spans in the trace as without them."""

import json
from pathlib import Path

import pytest

from cvbench import program_spans as PS
from cvbench import run, tracing

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 7
MAIN, OTHER = 11, 12


def _x(name, ts, dur, cat="user_annotation", tid=MAIN):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def _total(t0, n_chunks):
    """One traced total from ``t0``: the harness's spans, and per chunk a
    route span holding sources (with an h2d and a stats span nested),
    then an h2d span, and a device kernel; on another thread a program
    span that is not the main thread's."""
    ev = [_x("cvbench.total", t0, 1000 * n_chunks + 500),
          _x("cvbench.fit", t0 + 10, 80),
          _x("cvbench.folds", t0 + 100, 1000 * n_chunks + 300)]
    for c in range(n_chunks):
        s = t0 + 200 + 1000 * c
        ev += [
            _x(PS.ROUTE + "loocv", s, 600),
            _x(PS.SOURCES, s + 10, 100),
            _x(PS.H2D, s + 20, 30),
            _x(PS.STATS, s + 60, 20),
            _x(PS.STATS, s + 200, 50),
            _x(PS.H2D, s + 300, 250),
            _x("aten::mul", s + 210, 5, cat="cpu_op"),
            _x("loocv_tile_kernel", s + 250, 320, cat="kernel", tid=7),
            _x(PS.H2D, s + 400, 100, tid=OTHER),
        ]
    return ev


def _trace(tmp_path, strip=False, name="trace.json"):
    ev = _total(0, 2) + _total(10_000, 3)
    if strip:
        ev = [e for e in ev if not e["name"].startswith(PS.PREFIX)]
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


LEAST = {"fit": 1e-5, "folds": 1e-4, "fit_bound": "bytes",
         "folds_bound": "bytes"}


def test_load_keeps_the_main_threads_program_spans(tmp_path):
    program = PS.load(_trace(tmp_path))
    assert len(program) == 5 * 6
    assert program == sorted(program)
    assert {n for _, _, n in program} == {PS.ROUTE + "loocv", PS.SOURCES,
                                          PS.H2D, PS.STATS}


def test_self_time_subtracts_nested_spans(tmp_path):
    program = PS.load(_trace(tmp_path))
    sources = [p for p in program if p[2] == PS.SOURCES]
    # 100 us less the nested h2d (30) and stats (20)
    assert [PS.self_time(p, program) for p in sources] == [50.0] * 5
    route = next(p for p in program if p[2].startswith(PS.ROUTE))
    # 600 us less sources (100, its nested spans inside), stats 50, h2d 250
    assert PS.self_time(route, program) == 200.0
    stats = next(p for p in program if p[2] == PS.STATS)
    assert PS.self_time(stats, program) == 20.0


def test_readings_count_per_total(tmp_path):
    path = _trace(tmp_path)
    rec = tracing.read(path, LEAST, "batched")
    got = PS.readings(rec.spans("total"), PS.load(path))
    # totals of 2 and 3 chunks: 2 h2d spans a chunk of 30 + 250 us
    assert got == {"h2d_wait_ms": pytest.approx(2.5 * 0.28),
                   "h2d_per_total": 5.0,
                   "sources_ms": pytest.approx(2.5 * 0.05),
                   "stats_ms": pytest.approx(2.5 * 0.07),
                   "chunks": {"loocv": 2.5}}
    assert "reduce_fn_ms" not in got


def test_a_program_without_spans_reads_nothing(tmp_path):
    path = _trace(tmp_path, strip=True)
    rec = tracing.read(path, LEAST, "batched")
    assert PS.load(path) == []
    assert PS.readings(rec.spans("total"), []) == {}


def test_idle_by_program_span(tmp_path):
    path = _trace(tmp_path)
    rec = tracing.read(path, LEAST, "batched")
    got = dict(PS.idle_by_program_span(rec.gaps(), PS.load(path), top=20))
    # the first gap's midpoint (225 us) lies in the h2d span nested in
    # sources in the route span: the innermost one counts
    assert any(k.startswith(PS.H2D + " (") for k in got)
    assert any(k.startswith(PS.OUTSIDE) for k in got)
    assert sum(got.values()) == pytest.approx(
        sum(e - s for s, e in rec.gaps()) / 1e6)


def test_harness_readers_ignore_the_program_spans(tmp_path):
    """Every per-layer reader, and the breakdown's lists, read the same
    trace alike with the program's spans and without them."""
    with_spans = tracing.read(_trace(tmp_path), LEAST, "batched")
    without = tracing.read(_trace(tmp_path, True, "bare.json"), LEAST,
                           "batched")
    names = sorted(p.stem for p in (ROOT / "cvbench" / "metrics").glob(
        "*.py") if p.stem != "__init__")
    assert len(names) >= 7
    for n in names:
        reader = run.load_module("metrics", n)
        assert reader.read(with_spans) == reader.read(without), n
    assert with_spans.breakdown() == without.breakdown()


TINY = {
    "upstream_n100k.loocv": (dict(N=300, K=12, M=3, P=300, batch_size=64),
                             {"loocv": 5}, 3 * 5),
    # folds of 12 rows at K=1,100 take the packed route (the card's 500
    # take the epilogue); one h2d a chunk either way
    "widek_n5k.kfold10": (dict(N=120, K=1100, M=1, P=10, batch_size=1),
                          {"packed": 10}, 10),
    "upstream_n100k.kfold10000": (dict(N=300, K=12, M=3, P=30,
                                       batch_size=8), {"v3": 4}, 4),
    # cross_validate_reduce's hoisted LOOCV loop over 5 chunks of 60
    "upstream_n100k.loocv_reduce": (dict(N=300, K=12, M=3, P=300,
                                         batch_size=64), {}, 1 + 2 * 5),
}


@pytest.mark.parametrize("cell", list(TINY))
def test_traced_cell_reads_the_program(cell):
    override, chunks, h2d = TINY[cell]
    res = PS.run_cell(cell, SEED, 0.3, device="cpu", override=override)
    assert res["correct"]
    got = res["program_spans"]
    assert got["chunks"] == chunks
    assert got["h2d_per_total"] == h2d
    assert ("reduce_fn_ms" in got) == (cell.endswith("reduce"))
    spans_ms = got["h2d_wait_ms"] + got["sources_ms"] + got["stats_ms"]
    layer = res["metrics"].get("batched_ms") or res["metrics"][
        "reduce_sweep_ms"]
    assert 0 < spans_ms + got.get("reduce_fn_ms", 0) <= layer["value"]
    assert res["breakdown"]["idle_by_program_span"]
