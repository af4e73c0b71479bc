"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _module_consts(path: Path) -> dict:
    consts = {}
    for line in path.read_text().splitlines():
        m = re.match(r"^([A-Z_]+) = (\".*\")$", line)
        if m:
            consts[m.group(1)] = json.loads(m.group(2))
    return consts


def test_keys_and_command():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "cvbench/run.py"]
    assert BENCH["paths"] == ["cvbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # A full check with 24 cells fits in 43,200 s.
    cells = 24
    assert ((2 + 14 * cells) * (BENCH["run_seconds"] + 60)
            + cells * 2 * 90 + 1200) <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append((kind, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert len(set(n for _, n in names if _ in ("end_to_end", "per_layer"))
               ) == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    assert len(set(CELLS)) == len(CELLS)


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert list(e2e) == ["folds_per_s", "total_ms_p90", "peak_mem_gb",
                         "setup_s"]
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25


def test_configs_resolve():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        path = ROOT / c["file"]
        assert path.parent == ROOT / "cvbench" / "configs"
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and path.stem == c["name"]
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert 1 <= len(c["source"]) <= 200
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    spec = json.loads((ROOT / "cvbench" / "workloads" / f"{cell}.json")
                      .read_text())
    assert spec["name"] == cell and spec["config"] == w["config"]
    assert spec["chips"] == w["chips"] == 1 and spec["why"] == w["why"]
    assert cell == f"{cell.split('.')[0]}.{w['traffic']}"
    assert (ROOT / "cvbench" / "entries" / f"{spec['entry']}.py").is_file()
    if "reduction" in spec:
        assert (ROOT / "cvbench" / "reductions"
                / f"{spec['reduction']}.py").is_file()
    entry = (ROOT / "cvbench" / "entries" / f"{spec['entry']}.py").read_text()
    numbers = ["fit_rel_err"] + re.findall(
        r'"(\w+_rel_err)"', entry.split("NUMBERS = ", 1)[1].splitlines()[0])
    assert sorted(spec["limits"]) == sorted(numbers)
    per_layer = [m for m in BENCH["per_layer"]
                 if cell in m.get("workloads", [cell])]
    assert per_layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_reader(metric):
    m = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    consts = _module_consts(ROOT / "cvbench" / "metrics" / f"{metric}.py")
    assert consts == {"LAYER": m["layer"], "UNIT": m["unit"],
                      "BETTER": m["better"], "MOVES": m["moves"],
                      "SOURCE": m["source"]}
    assert m["moves"] == "folds_per_s"
    for cell in m.get("workloads", []):
        assert cell in CELLS
