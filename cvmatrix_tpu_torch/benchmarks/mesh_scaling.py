"""Mesh scaling proxy on gloo ranks on the host.

Counterpart of ``benchmarks/mesh_scaling.py``: it measures the SCALING
STRUCTURE of the mesh layer's reduce sweep
(:func:`cvmatrix_tpu_torch.parallel.distributed.sharded_cross_validate_reduce`)
over 1, 2 and 4 ranks, each a process spawned by
:func:`cvmatrix_tpu_torch.parallel.dryrun.dryrun_multichip` on the CPU over
gloo: every mesh-size-dependent cost the sweep has (the row-sharded fit's
``all_reduce``, the gathers' ``reduce_scatter``, splitting the folds, each
chunk's collectives), but no card-to-card bandwidth.

The ranks share the host's cores: each of n ranks runs ``cores / n`` torch
threads, so the compute does not grow with the mesh and ideal scaling is
FLAT folds/s. ``folds_per_sec(n)`` is P over the sweep's time on n ranks
(best of three blocks of ``SCALE_REPS`` sweeps), ``per_rank_folds_per_sec``
that over n, and ``scaling_efficiency(n) = folds_per_sec(n) /
folds_per_sec(1)`` (1.0: the sharded sweep adds no cost over one rank;
BASELINE.json's >= 80%-at-2-hosts bar needs real cards for the bandwidth
term). The sweeps run the per-fold engine (``impl="torch"``, the JAX
script's ``impl="xla"``). Each size's reductions are held against the
single-process per-fold engine at 1e-8 of their size.

Run it as ``python -m cvmatrix_tpu_torch.benchmarks.mesh_scaling --device
cpu [--out PATH]`` (or with ``BENCH_PLATFORM=cpu``): the proxy runs on the
host only, and without that request it raises, as every entry point of the
port does that is not on the card (the card's mesh is measured by
:mod:`~cvmatrix_tpu_torch.benchmarks.mesh_one_chip`). Knobs ``SCALE_N``
(16384), ``SCALE_K`` (64), ``SCALE_M`` (4), ``SCALE_P`` (4096),
``SCALE_SIZES`` ("1,2,4"), ``SCALE_REPS`` (5), ``SCALE_ROUNDS`` (3). It
prints a line a round and size, then the JSON summary, which it writes to
``--out`` (default ``chiprun_out/mesh_scaling_cpu_proxy.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch


def _data(n, k, m):
    rng = np.random.default_rng(0)
    return rng.random((n, k)), rng.random((n, m)), rng.random(n)


def trace_reduce(mats, stats):
    return torch.trace(mats[0])


def scaling_rank(mesh, n: int, k: int, m: int, p: int, reps: int,
                 out_dir: str) -> None:
    """One rank's part: the sharded fit and the timed sweeps; rank 0 writes
    ``folds_per_sec`` and the reductions to ``out_dir``."""
    import torch.distributed as dist

    from .. import CVConfig
    from ..parallel.distributed import (
        fit_sharded,
        sharded_cross_validate_reduce,
    )

    world = dist.get_world_size()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    cfg = CVConfig(True, True, True, True, ddof=1, dtype=np.float64)
    st = fit_sharded(cfg, mesh, *_data(n, k, m))
    idx = np.arange(p)[:, None] % n

    def sweep():
        return sharded_cross_validate_reduce(
            cfg, st, idx, mesh=mesh, reduce_fn=trace_reduce, batch_size=128,
            impl="torch")

    red = sweep()  # warm-up
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            sweep()
        best = min(best, (time.perf_counter() - t0) / reps)
    if dist.get_rank() == 0:
        np.save(os.path.join(out_dir, f"red_{world}.npy"), red.numpy())
        with open(os.path.join(out_dir, f"fps_{world}.json"), "w") as f:
            json.dump({"n_ranks": world, "folds_per_sec": p / best}, f)


def engine_reductions(n: int, k: int, m: int, p: int) -> np.ndarray:
    """The traces of the same folds from the single-process per-fold
    engine."""
    from .. import CVConfig, fit
    from ..core.fold import training_XTX

    cfg = CVConfig(True, True, True, True, ddof=1, dtype=np.float64)
    st = fit(cfg, *_data(n, k, m), device="cpu")
    xtx, _ = training_XTX(cfg, st, np.arange(p)[:, None] % n)
    return xtx.diagonal(dim1=1, dim2=2).sum(-1).numpy()


def run(n: int, k: int, m: int, p: int, sizes, reps: int,
        rounds: int) -> dict:
    from ..parallel.dryrun import dryrun_multichip

    best = {s: 0.0 for s in sizes}
    want = engine_reductions(n, k, m, p)
    errs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for rnd in range(rounds):
            for size in sizes:
                dryrun_multichip(size, "cpu", rank_fn=scaling_rank,
                                 args=(n, k, m, p, reps, tmp))
                with open(os.path.join(tmp, f"fps_{size}.json")) as f:
                    fps = json.load(f)["folds_per_sec"]
                red = np.load(os.path.join(tmp, f"red_{size}.npy"))
                err = float(np.abs(red - want).max())
                if not err <= 1e-8 * max(1.0, float(np.abs(want).max())):
                    raise AssertionError(
                        f"{size} ranks: reductions {err:.3e} off the "
                        "per-fold engine")
                errs[size] = max(errs.get(size, 0.0), err)
                best[size] = max(best[size], fps)
                print(f"round {rnd} n_ranks={size} folds/s={fps:.0f}",
                      flush=True)
    rows = [{"n_ranks": s, "folds_per_sec": best[s],
             "per_rank_folds_per_sec": best[s] / s,
             "scaling_efficiency": best[s] / best[sizes[0]],
             "max_abs_err_vs_engine": errs[s]} for s in sizes]
    return {"metric": "mesh_scaling_proxy", "platform": "cpu",
            "backend": "gloo", "rows": rows,
            "config": {"N": n, "K": k, "M": m, "P": p, "rounds": rounds,
                       "reps": reps, "cpu_count": os.cpu_count()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        "chiprun_out", "mesh_scaling_cpu_proxy.json"))
    ap.add_argument("--device", choices=("cuda", "cpu"),
                    default=os.environ.get("BENCH_PLATFORM") or "cuda")
    args = ap.parse_args(argv)
    if args.device != "cpu":
        raise RuntimeError(
            "mesh_scaling is a proxy on gloo ranks on the host: pass "
            "--device cpu (or set BENCH_PLATFORM=cpu); the mesh on the card "
            "is measured by cvmatrix_tpu_torch.benchmarks.mesh_one_chip.")
    env = os.environ
    summary = run(int(env.get("SCALE_N", 16384)), int(env.get("SCALE_K", 64)),
                  int(env.get("SCALE_M", 4)), int(env.get("SCALE_P", 4096)),
                  [int(s) for s in env.get("SCALE_SIZES", "1,2,4").split(",")],
                  int(env.get("SCALE_REPS", 5)),
                  int(env.get("SCALE_ROUNDS", 3)))
    print(json.dumps(summary), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
