"""A small sharded run over spawned ranks, PyTorch port.

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``: one
tiny run of the mesh layer's whole path (row-sharded fit with summed
products, fold-sharded gathers and fold math through the kernels, the
reduce sweep and the natural-order LOOCV sweep), each result checked
against the single-device port. Run it as::

    python -c "from cvmatrix_tpu_torch.parallel.dryrun import \\
dryrun_multichip; dryrun_multichip(2)"

On CUDA the ranks share the cards present (NCCL where each rank has its
own card, gloo where ranks share one); ``device_type="cpu"`` runs on the
host over gloo.
"""

from __future__ import annotations

import socket

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["dryrun_multichip", "dryrun_rank"]


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"mesh dry run: {what}")


def dryrun_rank(mesh) -> None:
    """One rank's part of the dry run on ``mesh`` (every rank calls it);
    raises ``AssertionError`` where a result departs from the single-device
    port by more than 1e-8 of its size."""
    from ..config import CVConfig
    from ..core.fit import fit
    from ..core.fold import training_matrices
    from ..models.partitioner import Partitioner
    from .distributed import (
        _device,
        fit_sharded,
        sharded_cross_validate_reduce,
        sharded_training_matrices,
    )

    cfg = CVConfig(True, True, True, True, ddof=1, dtype=np.float64)
    rng = np.random.default_rng(0)
    n, k, m = 16 * mesh.size() + 3, 16, 2  # N that no world size divides
    X, Y, w = rng.random((n, k)), rng.random((n, m)), rng.random(n)
    state = fit_sharded(cfg, mesh, X, Y, w)
    ref = fit(cfg, X, Y, w, device=_device(mesh))

    p = Partitioner(np.arange(n) % 5)  # 5 unequal folds: padding and mask
    keys, idx, mask = p.padded_batches()
    (xtx, xty), _ = sharded_training_matrices(cfg, state, idx, mask,
                                              mesh=mesh)
    _check(xtx.shape == (len(keys), k, k) and xty.shape == (len(keys), k, m),
           f"shapes {tuple(xtx.shape)}, {tuple(xty.shape)}")
    (rx, _), _ = training_matrices(cfg, ref, p.get_validation_indices(keys[0]))
    err = float((xtx[0] - rx).abs().max())
    _check(err < 1e-8 * max(1.0, float(rx.abs().max())),
           f"fold 0 against the single-device port: {err:.3e}")

    def trace(mats, stats):
        return torch.trace(mats[0])

    red = sharded_cross_validate_reduce(cfg, state, idx, mask, mesh=mesh,
                                        reduce_fn=trace)
    want = float(torch.trace(rx))
    _check(abs(float(red[0]) - want) < 1e-8 * max(1.0, abs(want)),
           f"reduce sweep {float(red[0])!r} against {want!r}")

    # natural-order LOOCV: no rows move, each rank sweeps its own rows
    red_lo = sharded_cross_validate_reduce(cfg, state, np.arange(n)[:, None],
                                           mesh=mesh, reduce_fn=trace)
    (rx0, _), _ = training_matrices(cfg, ref, np.array([n - 1]))
    want = float(torch.trace(rx0))
    _check(red_lo.shape == (n,)
           and abs(float(red_lo[-1]) - want) < 1e-8 * max(1.0, abs(want)),
           f"LOOCV sweep {tuple(red_lo.shape)}, last fold "
           f"{float(red_lo[-1])!r} against {want!r}")


def _rank_main(rank: int, world: int, init_method: str, backend: str,
               device_type: str, rank_fn, args) -> None:
    from .distributed import make_mesh
    from .multihost import initialize

    initialize(init_method, world, rank, backend=backend,
               device_type=device_type)
    try:
        rank_fn(make_mesh(device_type), *args)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_ranks: int, device_type: str = "cuda", *,
                     rank_fn=dryrun_rank, args=()) -> None:
    """Spawn ``n_ranks`` processes that form a process group over
    ``localhost`` and run ``rank_fn(mesh, *args)`` in each (by default
    :func:`dryrun_rank`; another function must be importable by name, as
    spawned processes import it); raises if any rank fails. On CUDA it
    needs a card (NCCL when every rank has its own, else gloo with the
    ranks sharing the cards)."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise ValueError("no CUDA card: torch.cuda.is_available() is "
                             "false; pass device_type='cpu'.")
        backend = ("nccl" if n_ranks <= torch.cuda.device_count()
                   else "gloo")
    else:
        backend = "gloo"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.multiprocessing.spawn(
        _rank_main, args=(n_ranks, f"tcp://127.0.0.1:{port}", backend,
                          device_type, rank_fn, tuple(args)),
        nprocs=n_ranks, join=True)
