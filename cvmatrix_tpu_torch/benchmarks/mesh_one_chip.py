"""Mesh-of-one against single-device fold throughput on one card.

Counterpart of ``benchmarks/mesh_one_chip.py``: the same fold sweep three
ways on ONE device, weighted, all four flags on, float64, data from seed 42:

  1. single-device materialize: ``materialize_sweep`` (the grid's
     primitive; every fold's matrices produced, none consumed),
  2. single-device reduce: ``cross_validate_reduce`` with the probe
     ``reduce_fn`` (the same work per chunk as the mesh path: matrices,
     per-fold statistics and a reduction), and
  3. mesh(1): ``sharded_cross_validate_reduce`` over the mesh layer at
     world size 1 (NCCL on the card, an in-process store; gloo with
     ``--device cpu``).

``mesh1_over_single_reduce`` (the same workload, mesh on and off) is the
mesh's cost; ``mesh1_over_single`` (against materialize) also carries the
reduce sweep's own work. Both reduce legs run at one chunk size
(``BENCH_BATCH``, default 1000) so the ratio measures the mesh, not the
chunking. Each leg is warmed up once and timed once (host clock between
synchronisations).

Run it as ``python -m cvmatrix_tpu_torch.benchmarks.mesh_one_chip [--out
PATH] [--device cpu]``; knobs ``BENCH_N`` (100000), ``BENCH_K`` (500),
``BENCH_M`` (10), ``BENCH_PS`` ("1000,10000"), ``BENCH_BATCH`` (1000). It
prints one JSON row a P and writes them to ``--out`` (default
``chiprun_out/mesh_one_chip.json``). Without a card it raises unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def probe_reduce(mats, stats):
    """A fold's reduction: XTX[0, 0] + XTY[0, 0] (indexed, no copy)."""
    xtx, xty = mats
    return xtx[0, 0] + xty[0, 0]


def run(ps, n: int, k: int, m: int, batch: int, device="cuda") -> list:
    """The three legs at each P of ``ps``; returns the rows."""
    import torch.distributed as dist

    from .. import CVConfig, Partitioner, fit
    from ..models.sweep import cross_validate_reduce, materialize_sweep
    from ..parallel.distributed import (
        fit_sharded,
        make_mesh,
        sharded_cross_validate_reduce,
    )
    from ..parallel.multihost import initialize
    from ..utils.profiling import Stopwatch
    from .grid import bench_device, card_line

    device = bench_device("cpu" if str(device) == "cpu" else None)
    card = card_line(device)
    rng = np.random.default_rng(42)
    X, Y, w = rng.random((n, k)), rng.random((n, m)), rng.random(n)
    cfg = CVConfig(True, True, True, True, ddof=1, dtype=np.float64)
    initialize(world_size=1, rank=0, device_type=device.type)
    rows = []
    try:
        mesh = make_mesh(device.type)
        state = fit(cfg, X, Y, w, validate=False, device=device)
        sstate = fit_sharded(cfg, mesh, X, Y, w)
        for p in ps:
            idx = np.stack(list(Partitioner(np.arange(n) % p)
                                .folds_dict.values()))
            legs = {
                "single": lambda: materialize_sweep(cfg, state, idx),
                "single_reduce": lambda: cross_validate_reduce(
                    cfg, state, idx, reduce_fn=probe_reduce,
                    batch_size=batch),
                "mesh1": lambda: sharded_cross_validate_reduce(
                    cfg, sstate, idx, mesh=mesh, reduce_fn=probe_reduce,
                    batch_size=batch),
            }
            for leg in legs.values():  # warm-up
                leg()
            t, out = {}, {}
            for name, leg in legs.items():
                with Stopwatch(device=device) as sw:
                    out[name] = leg()
                t[name] = sw.elapsed
            red1, redm = out["single_reduce"], out["mesh1"]
            row = {
                "P": p, "N": n, "K": k, "M": m, "batch_size": batch,
                "platform": device.type, "card": card,
                "single_chip_s": t["single"],
                "single_reduce_s": t["single_reduce"],
                "mesh1_s": t["mesh1"],
                "single_folds_per_sec": p / t["single"],
                "single_reduce_folds_per_sec": p / t["single_reduce"],
                "mesh1_folds_per_sec": p / t["mesh1"],
                "mesh1_over_single": t["mesh1"] / t["single"],
                "mesh1_over_single_reduce": t["mesh1"] / t["single_reduce"],
                "single_probe": float(out["single"]),
                "reduce_fold0": float(red1[0]),
                "mesh1_fold0": float(redm[0]),
                "mesh1_vs_reduce_max_abs": float((redm - red1).abs().max()),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        dist.destroy_process_group()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "mesh_one_chip.json"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    env = os.environ
    rows = run([int(x) for x in env.get("BENCH_PS", "1000,10000").split(",")],
               int(env.get("BENCH_N", 100_000)), int(env.get("BENCH_K", 500)),
               int(env.get("BENCH_M", 10)), int(env.get("BENCH_BATCH", 1000)),
               args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
