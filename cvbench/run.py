"""Run one cell of the benchmark of ``cvmatrix_tpu_torch`` once.

    python3 cvbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the NVIDIA card(s) the cell
asks for; without them it exits with code 3 and prints no result.

A cell is ``workloads/<cell>.json``: its configuration
(``configs/<config>.json``), its entry (``entries/<entry>.py``), its fold
scheme and chunk, its reduction (``reductions/<name>.py``) where it has one,
and the limits of the numbers ``correct`` compares. The metrics are those
``BENCHMARK.json`` lists for the cell: the end-to-end ones here, each
per-layer one by its reader ``metrics/<metric>.py``. This file names no
cell.

Set-up (import, CUDA init, data, one warm total, which loads or builds the
kernel libraries) is timed as ``setup_s``. Then a closed loop of totals runs
for ``--seconds``: before each, the weights are drawn anew on the card; a
total is one ``fit`` plus every fold through the entry, timed on the host
clock from a ``synchronize()`` to a ``synchronize()``. With ``--trace 1``
the first ``trace_totals`` totals of the window run under
``torch.profiler`` with the harness's spans. Once the window has closed and
the program's state is freed, the folds each total set aside are checked
against ``reference.py``. The last line on stdout is one JSON object; the
numbers compared, each beside its limit, end stderr and the line.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if __name__ == "__main__":
    # Run as a script: the package and the program come from the checkout.
    sys.path[0] = str(ROOT)

# Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "cvmatrix_tpu")
BUILD_DIR = ROOT / ".cache" / "cvmatrix_tpu_torch"


def say(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``cvbench/<kind>/<name>.py`` as a module of the package."""
    path = HERE / kind / f"{name}.py"
    mod_name = f"cvbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    importlib.import_module(f"cvbench.{kind}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that apply to ``cell``."""
    return [m for m in manifest()[kind]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def clean_env(env: dict) -> None:
    """The program's knobs as the cell sets them and no others."""
    for k in [k for k in os.environ if k.startswith("CVMATRIX_TPU")]:
        del os.environ[k]
    os.environ.update({k: str(v) for k, v in env.items()})


class Ctx:
    """One cell: its configuration and traffic, its entry and reduction,
    the program's configuration object, and the device. ``override``
    replaces configuration or cell keys (the CPU tests' tiny sizes)."""

    def __init__(self, name: str, device, override=None) -> None:
        import numpy as np

        from cvmatrix_tpu_torch.config import CVConfig

        from cvbench import traffic

        override = override or {}
        self.cell = {**load_json("workloads", name)}
        self.cfg = load_json("configs", self.cell["config"])
        for k, v in override.items():
            (self.cfg if k in self.cfg else self.cell)[k] = v
        self.entry = load_module("entries", self.cell["entry"])
        self.reduction = (load_module("reductions", self.cell["reduction"])
                          if "reduction" in self.cell else None)
        self.folds = traffic.Folds(self.cfg["N"], self.cell["P"],
                                   self.cell["batch_size"],
                                   self.cell.get("masked", False))
        self.config = CVConfig(
            center_X=self.cfg["center_X"], center_Y=self.cfg["center_Y"],
            scale_X=self.cfg["scale_X"], scale_Y=self.cfg["scale_Y"],
            ddof=self.cfg["ddof"], dtype=np.dtype(self.cfg["dtype"]).type)
        self.device = device
        self.out_values = None  # values the entry hands back a fold

    def least(self) -> dict:
        """The least seconds of the fit and of one total's folds."""
        from cvbench import costs

        c = self.cfg
        item = 8 if c["dtype"] == "float64" else 4
        fit = costs.least_seconds(*costs.fit_cost(
            c["N"], c["K"], c["M"], item, c["weighted"]))
        every = self.reduction is None or self.reduction.EVERY_ENTRY
        folds = costs.least_seconds(*costs.folds_cost(
            self.folds.shapes(), c["K"], c["M"], item, c["weighted"],
            self.out_values, every))
        return {"fit": fit[0], "folds": folds[0], "fit_bound": fit[1],
                "folds_bound": folds[1]}


def _span(on: bool, name: str):
    import torch

    return (torch.profiler.record_function(name) if on
            else contextlib.nullcontext())


def _to_host(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    return tree


FIT_FIELDS = ("sum_X", "sum_Y", "sum_sq_X", "sum_sq_Y", "sum_w")


def _fit_out(state, rows):
    out = {"XTX": state.XTX.index_select(0, rows),
           "XTY": state.XTY.index_select(0, rows)}
    for f in FIT_FIELDS:
        out[f] = getattr(state, f)
    return _to_host(out)


def _p90(values) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def _nvidia_smi() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return res.stdout.strip().splitlines()[0] if res.stdout else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", override=None, t0: float = _T0,
             fit_fn=None) -> dict:
    """One run of cell ``name``; returns the result line as a dict.
    ``device="cpu"`` with ``override`` is the CPU tests' tiny path, through
    the program's plain twins; the benchmark's command runs on the card.
    ``fit_fn`` replaces the program's fit (the tests' faults)."""
    import torch

    from cvbench import compare, reference, traffic

    fit_mod = importlib.import_module("cvmatrix_tpu_torch.core.fit")
    phases = {"import_s": time.perf_counter() - t0}

    t = time.perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.zeros(1, device=dev)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    phases["cuda_init_s"] = time.perf_counter() - t

    t = time.perf_counter()
    ctx = Ctx(name, dev, override)
    cfg, cell = ctx.cfg, ctx.cell
    X, Y = traffic.inputs(cfg, seed, dev)
    sync()
    phases["data_s"] = time.perf_counter() - t

    def total(i: int, traced: bool):
        """Total ``i``: the weights, then the timed fit and folds."""
        w = traffic.weights(cfg, seed, i, dev)
        smp = traffic.sample(cfg, ctx.folds, seed, i)
        smp_dev = SimpleNamespace(folds=smp.folds, rows=[
            None if len(r) == cfg["K"] else torch.as_tensor(r, device=dev)
            for r in smp.rows])
        fit_rows = torch.as_tensor(smp.fit_rows, device=dev)
        fit = fit_fn or fit_mod.fit
        sync()
        t_start = time.perf_counter()
        with _span(traced, "cvbench.total"):
            with _span(traced, "cvbench.fit"):
                state = fit(ctx.config, X, Y, w)
                if traced:
                    sync()
            with _span(traced, "cvbench.folds"):
                kept = ctx.entry.run(ctx, state, smp_dev,
                                     lambda n: _span(traced, n))
                if traced:
                    sync()
        sync()
        seconds_taken = time.perf_counter() - t_start
        return seconds_taken, (i, smp, _fit_out(state, fit_rows),
                               _to_host(kept))

    built = set(os.listdir(BUILD_DIR)) if BUILD_DIR.is_dir() else set()
    t = time.perf_counter()
    total(-1, False)
    phases["warm_total_s"] = time.perf_counter() - t
    now = set(os.listdir(BUILD_DIR)) if BUILD_DIR.is_dir() else set()
    phases["libraries_built"] = len(
        [f for f in now - built if f.endswith(".so")])
    least = ctx.least()

    # ---- the window ---------------------------------------------------- #
    prof = None
    trace_n = cell.get("trace_totals", 5) if trace else 0
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t0
    records, durations = [], []
    w_start = time.perf_counter()
    i = 0
    while time.perf_counter() - w_start < seconds:
        d, rec = total(i, i < trace_n)
        durations.append(d)
        records.append(rec)
        i += 1
        if prof is not None and i == trace_n:
            prof.stop()
    elapsed = time.perf_counter() - w_start
    if prof is not None and i < trace_n:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    for k, v in phases.items():
        say(f"setup {k}: {v}")
    say(f"setup_s: {setup_s}")

    # ---- the check ----------------------------------------------------- #
    t = time.perf_counter()
    numbers = ("fit_rel_err", *ctx.entry.NUMBERS)
    limits = {n: float(cell["limits"][n]) for n in numbers}
    worst = {n: 0.0 for n in numbers}
    failed = 0
    for i, smp, fit_out, kept in records:
        w = traffic.weights(cfg, seed, i, dev)
        ref = reference.fit_rows(X, Y, w, smp.fit_rows)
        got = {"fit_rel_err": max(compare.gap(fit_out[k], ref[k])
                                  for k in fit_out if fit_out[k] is not None)}
        for p, rows in zip(smp.folds, smp.rows):
            if p not in kept:
                got.update({n: math.inf for n in ctx.entry.NUMBERS})
                continue
            nums = ctx.entry.judge(
                ctx, p, kept[p], X, Y, w,
                None if len(rows) == cfg["K"] else torch.as_tensor(rows))
            for n, v in nums.items():
                got[n] = max(got.get(n, 0.0), v)
        for n, v in got.items():
            worst[n] = max(worst[n], v)
        if any(not got[n] <= limits[n] for n in got):
            failed += 1
    check_s = time.perf_counter() - t
    say(f"check: {len(records)} totals, "
        f"{sum(len(r[1].folds) for r in records)} folds against the "
        f"reference in {check_s} s")

    attempted = len(records)
    correct = attempted > 0 and failed == 0
    card = _nvidia_smi() if cuda else "cpu"
    say(f"card: {card}; least fit {least['fit']} s ({least['fit_bound']}), "
        f"least folds {least['folds']} s ({least['folds_bound']}); peaks "
        f"3.35 TB/s, 67 TFLOP/s")
    result = {
        "correct": correct, "attempted": attempted, "failed": failed,
        "metrics": {},
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak),
                   "power": card},
    }
    if not trace:
        values = {
            "folds_per_s": attempted * ctx.folds.P / elapsed,
            "total_ms_p90": _p90(durations) * 1e3 if durations else None,
            "peak_mem_gb": peak / 1e9,
            "setup_s": setup_s,
        }
        for m in cell_metrics(name, "end_to_end"):
            if values.get(m["name"]) is not None:
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
        say(f"window: {attempted} totals in {elapsed} s; totals ms min "
            f"{min(durations) * 1e3}, median "
            f"{statistics.median(durations) * 1e3}, max "
            f"{max(durations) * 1e3}")
    else:
        from cvbench import tracing

        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            rec = tracing.read(path, least, cell["entry"])
        for m in cell_metrics(name, "per_layer"):
            v = load_module("metrics", m["name"]).read(rec)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
        if rec.totals:
            result["device"]["busy_s"] = rec.busy_total() / 1e6
            result["device"]["window_s"] = rec.wall_total() / 1e6
            result["breakdown"] = rec.breakdown()
    checks = {}
    for n in numbers:
        v = worst[n]
        checks[n] = {"value": v if math.isfinite(v) else str(v),
                     "limit": limits[n]}
        say(f"compared {n}: {v} (limit {limits[n]})")
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_json("workloads", args.workload)
    clean_env(cell.get("env", {}))

    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        say(f"cell {args.workload} needs {cell['chips']} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count()}")
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        say(f"loaded in the run: {', '.join(bad)}; no result")
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
