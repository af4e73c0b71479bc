"""The float32 control of a PLS cell's limit, at the cell's own size.

    python3 cvbench/calibrate_pls.py --workload ikpls_n100k.loocv \\
        --control-seeds 3,4,5 --totals 8

The control is the reference put in the program's place and computed in
float32 (the nearest precision below the configuration's float64, TF32
off): ``reference_pls.fold_press`` in float32 for the folds that
``--totals`` totals of a run would hand to the check, and the fit's rows of
``reference.fit_rows`` in float32, each judged as a run judges the
program's (the entry's ``judge``, ``compare.gap``). The program's readings
come from ``calibrate.py --seeds``, which runs the cell. Prints one JSON
line a seed; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

import torch  # noqa: E402

from cvbench import compare, reference, reference_pls, run, traffic  # noqa: E402,E501


def control(name: str, seed: int, totals: int, device: str = "cuda",
            override=None, dtype=torch.float32) -> dict:
    """The control's worst numbers over the first ``totals`` totals."""
    ctx = run.Ctx(name, torch.device(device), override)
    X, Y = traffic.inputs(ctx.cfg, seed, ctx.device)
    worst = {}
    for i in range(totals):
        w = traffic.weights(ctx.cfg, seed, i, ctx.device)
        smp = traffic.sample(ctx.cfg, ctx.folds, seed, i)
        ref = reference.fit_rows(X, Y, w, smp.fit_rows)
        low = reference.fit_rows(X, Y, w, smp.fit_rows, dtype=dtype)
        got = {"fit_rel_err": max(compare.gap(low[k], ref[k]) for k in ref)}
        for p in smp.folds:
            out = {"press": reference_pls.fold_press(
                X, Y, w, ctx.folds.rows(p), ctx.cfg, dtype=dtype).cpu()}
            for n, v in ctx.entry.judge(ctx, p, out, X, Y, w, None).items():
                got[n] = max(got.get(n, 0.0), v)
        for n, v in got.items():
            worst[n] = max(worst.get(n, 0.0), v)
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--totals", type=int, default=8)
    args = ap.parse_args()
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        print(json.dumps({"cell": args.workload, "side": "control float32",
                          "seed": seed,
                          "numbers": control(args.workload, seed,
                                             args.totals)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
