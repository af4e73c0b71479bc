"""The readings the limits of ``correct`` are set from, at a cell's own size.

    python3 cvbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 4 --totals 8

Lower readings: the program's numbers in short runs of the cell
(``run.run_cell``, one process, one seed a run). Upper readings: the
control, the reference put in the program's place and computed in float32
(the nearest precision below the configuration's float64, TF32 off), judged
on the folds that ``--totals`` totals of a run would hand to the check,
against the float64 reference, by the entry's own judge. Prints one JSON
line a reading; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

import torch  # noqa: E402

from cvbench import compare, reference, run, traffic  # noqa: E402


def control_outputs(ctx, X, Y, w, smp, dtype):
    """What the control hands the check for the sampled folds: the
    reference's fold outputs computed in ``dtype``."""
    kept = {}
    for p, rows in zip(smp.folds, smp.rows):
        r = None if len(rows) == ctx.cfg["K"] else rows
        xtx, xty, stats = reference.fold(X, Y, w, ctx.folds.rows(p), ctx.cfg,
                                         None if ctx.reduction else r,
                                         dtype=dtype)
        if ctx.reduction is not None:
            kept[p] = {"out": ctx.reduction.reduce((xtx, xty), stats).cpu()}
        else:
            kept[p] = {"XTX": xtx.cpu(), "XTY": xty.cpu(),
                       "stats": [None if s is None else s.cpu()
                                 for s in stats]}
    return kept


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
        kept = control_outputs(ctx, X, Y, w, smp, dtype)
        for p, rows in zip(smp.folds, smp.rows):
            r = None if len(rows) == ctx.cfg["K"] else torch.as_tensor(rows)
            for n, v in ctx.entry.judge(ctx, p, kept[p], X, Y, w, r).items():
                got[n] = max(got.get(n, 0.0), v)
        for n, v in got.items():
            worst[n] = max(worst.get(n, 0.0), v)
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--totals", type=int, default=8)
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        res = run.run_cell(args.workload, seed, args.seconds, False)
        print(json.dumps({"cell": args.workload, "side": "program",
                          "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        print(json.dumps({"cell": args.workload, "side": "control float32",
                          "seed": seed,
                          "numbers": control(args.workload, seed,
                                             args.totals)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
