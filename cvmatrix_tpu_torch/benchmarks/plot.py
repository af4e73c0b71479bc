"""Draw the port's grid CSV with the JAX grid's four figure families.

Run on a host with pandas and matplotlib (the card's machine has neither)::

    python -m cvmatrix_tpu_torch.benchmarks.plot results.csv

It loads ``benchmarks/plot_benchmark.py`` by path (that file imports no
JAX), keeps the newest row per configuration (``latest_per_config``) and
writes ``<csv>_vs_naive.png``, ``_combos.png``, ``_roofline.png`` (against
the H100's 3,350 GB/s) and ``_jit_modes.png`` beside the CSV; a family
whose rows are missing (no naive rows, one mode) is skipped, as there.
Nothing in the package or in ``chip_smoke.py`` imports this module.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import pandas as pd

H100_HBM_GBPS = 3350.0
_PLOT_BENCHMARK = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "benchmarks", "plot_benchmark.py")


def load_plot_benchmark():
    """``benchmarks/plot_benchmark.py`` as a module."""
    spec = importlib.util.spec_from_file_location("plot_benchmark",
                                                  _PLOT_BENCHMARK)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plot_csv(csv_path: str, hbm_gbps: float = H100_HBM_GBPS) -> list:
    """The four figure families of ``csv_path``; returns the files written."""
    pb = load_plot_benchmark()
    df = pb.latest_per_config(pd.read_csv(csv_path))
    base = os.path.splitext(csv_path)[0]
    outs = {base + "_vs_naive.png": pb.plot_vs_naive,
            base + "_combos.png": pb.plot_combos,
            base + "_roofline.png": lambda d, o: pb.plot_roofline(
                d, o, hbm_gbps=hbm_gbps),
            base + "_jit_modes.png": pb.plot_jit_modes}
    for out, fn in outs.items():
        fn(df, out)
    return [out for out in outs if os.path.exists(out)]


if __name__ == "__main__":
    plot_csv(sys.argv[1] if len(sys.argv) > 1 else "benchmark_results.csv")
