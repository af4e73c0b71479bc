"""Wide-genomics reduce sweep: N=5,000, K=20,000, M=1, P=10 (BASELINE.json
config 4), the counterpart of ``benchmarks/widek_genomics.py``.

Unweighted, all four centre/scale flags on, float64, data from
``np.random.default_rng(0)``; the fit, then ten folds through
:func:`~cvmatrix_tpu_torch.models.sweep.cross_validate_reduce` with
``batch_size=1`` and ``donate_state=True`` (accepted, a no-op in torch), each
fold's 20,000 x 20,000 training matrix (3.2 GB) consumed on the device by
``consume`` (the mean of its diagonal and the first column of XTY). At this
width the reduce sweep takes its generic per-chunk body and each fold the
``torch.bmm`` + epilogue route.

The spot check runs one fold through the per-fold engine on the CPU in
float64 (the fitted state copied to the host) against the sweep's first
fold: ``|d| < 1e-6`` on the diagonal mean, as in the JAX script. The row
holds the kernel launches of the timed sweep. Peak device memory is
``torch.cuda.max_memory_allocated`` over the data and the two fits
(``peak_fit_gb``) and over the timed sweep with its state (``peak_sweep_gb``); it
replaces ``benchmarks/widek_memstats.py``, whose compiler memory analysis
of the JAX program has no torch counterpart (torch compiles no program).

Run it as ``python -m cvmatrix_tpu_torch.benchmarks.widek_genomics [--out
PATH] [--device cpu] [--n N --k K]``; it prints one JSON row and writes it to
``--out`` (default ``chiprun_out/widek_genomics.json``), never into
``benchmarks/``. Without a card it raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

N, K, M, P = 5_000, 20_000, 1, 10


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def consume(mats, stats):
    """A fold's reduction on the device: the mean of XTX's diagonal and the
    first column of XTY."""
    xtx, xty = mats
    return {"diag_mean": torch.mean(torch.diagonal(xtx)), "xty0": xty[:, 0]}


def host_copy(state):
    """The fitted state copied to the host, aliases kept (unweighted, ``WX``
    is ``X``)."""
    moved = {}

    def move(t):
        if t is not None and id(t) not in moved:
            moved[id(t)] = t.cpu()
        return None if t is None else moved[id(t)]

    return dataclasses.replace(state, **{
        f.name: move(getattr(state, f.name))
        for f in dataclasses.fields(state)})


def run(n: int = N, k: int = K, m: int = M, p: int = P,
        device="cuda") -> dict:
    """The sweep on ``device``; returns the JSON row."""
    from .. import CVConfig, Partitioner, fit
    from ..core.fold import training_XTX_XTY
    from ..models.sweep import cross_validate_reduce
    from ..ops import launch_counts, reset_launch_counts
    from ..utils.profiling import Stopwatch
    from .grid import bench_device, card_line

    device = bench_device("cpu" if str(device) == "cpu" else None)
    cuda = device.type == "cuda"
    rng = np.random.default_rng(0)
    cfg = CVConfig(True, True, True, True, ddof=1, dtype=np.float64)
    X, Y = rng.random((n, k)), rng.random((n, m))  # unweighted: X aliases WX
    Xd, Yd = (torch.from_numpy(a).to(device) for a in (X, Y))
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    def fit_once():
        return fit(cfg, Xd, Yd, None, validate=False, copy=False)

    with Stopwatch(device=device) as sw:
        state = fit_once()
    log(f"first fit {sw.elapsed:.3f}s")
    with Stopwatch(device=device) as sw:
        state = fit_once()
    t_fit = sw.elapsed
    log(f"warm fit {t_fit:.3f}s")
    peak_fit = torch.cuda.max_memory_allocated(device) if cuda else None

    _, idx, mask = Partitioner(np.arange(n) % p).padded_batches()

    def sweep(st):
        return cross_validate_reduce(cfg, st, idx, mask, reduce_fn=consume,
                                     batch_size=1, donate_state=True)

    # Spot check: the per-fold engine on the host in float64, on a copy of
    # the fitted state, against the sweep's first fold.
    state_h = host_copy(state)
    (xtx, xty), _ = training_XTX_XTY(cfg, state_h, idx[0])
    engine_diag = float(consume((xtx, xty), None)["diag_mean"])
    del state_h, xtx, xty
    with Stopwatch(device=device) as sw:
        out = sweep(state)
    kernel_diag = float(out["diag_mean"][0])
    log(f"first reduce sweep {sw.elapsed:.3f}s")
    d = abs(kernel_diag - engine_diag)
    log(f"sweep vs per-fold engine on the host: diag_mean |d|={d:.3e}")
    if not d < 1e-6:
        raise AssertionError(f"wide K: the sweep's first fold is {d:.3e} off "
                             "the per-fold engine")

    state = out = None
    state = fit_once()
    reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    with Stopwatch(device=device) as sw:
        out = sweep(state)
        float(out["diag_mean"][0])
    t_folds = sw.elapsed
    launches = launch_counts()
    log(f"warm: fit={t_fit:.3f}s folds={t_folds:.3f}s "
        f"({p / (t_fit + t_folds):.2f} folds/s at K={k:,})")
    return {
        "N": n, "K": k, "M": m, "P": p, "dtype": "float64",
        "config": "TTTT", "platform": device.type, "card": card_line(device),
        "warm_fit_s": t_fit, "warm_folds_s": t_folds,
        "total_s": t_fit + t_folds,
        "folds_per_sec": p / (t_fit + t_folds),
        "sweep_vs_engine_diag_abs_d": d,
        "launches": launches,
        "peak_fit_gb": None if peak_fit is None else peak_fit / 1e9,
        "peak_sweep_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                          if cuda else None),
        "diag_mean": out["diag_mean"].cpu().tolist(),
        "xty0_shape": list(out["xty0"].shape),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "widek_genomics.json"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--k", type=int, default=K)
    args = ap.parse_args(argv)
    row = run(args.n, args.k, device=args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(row, f, indent=1)
    print(json.dumps(row), flush=True)
    log("WIDEK OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
