"""Scaling over a mesh: row-sharded fit + fold-sharded fold math (the JAX
package's ``examples/training_matrices_mesh.py``).

The port's mesh layer is SPMD on ``torch.distributed``, one process a
device. Run it on the cards under ``torchrun``::

    torchrun --standalone --nproc-per-node=<cards> \\
        -m cvmatrix_tpu_torch.examples.training_matrices_mesh

(``--device cpu`` there joins the group over gloo), or on the host over
gloo, ``--ranks`` processes spawned through
:func:`cvmatrix_tpu_torch.parallel.dryrun.dryrun_multichip`::

    python -m cvmatrix_tpu_torch.examples.training_matrices_mesh \\
        --device cpu [--ranks 2]

Rank 0 prints.
"""

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from cvmatrix_tpu_torch import CVConfig, Partitioner
from cvmatrix_tpu_torch.parallel.distributed import (
    fit_sharded,
    make_mesh,
    sharded_training_matrices,
)


def mesh_main(mesh) -> None:
    """Every rank's part of the example on ``mesh``."""
    rank, world = dist.get_rank(), dist.get_world_size()

    def show(*a):
        if rank == 0:
            print(*a, flush=True)

    rng = np.random.default_rng(42)
    N, K, M = 10_000, 64, 4
    X = rng.uniform(size=(N, K))
    Y = rng.uniform(size=(N, M))
    weights = rng.uniform(size=N) + 0.1
    folds = np.arange(N) % 100

    show(f"mesh: {{'rows': {world}}} over {world} {mesh.device_type} ranks")

    cfg = CVConfig(center_X=True, center_Y=True, scale_X=True, scale_Y=True)
    state = fit_sharded(cfg, mesh, X, Y, weights)
    show("fit: XTX", tuple(state.local.XTX.shape),
         "sharding: replicated on every rank")
    show("fit: X  ", (state.n_data, state.K), "sharding: rows, "
         f"{tuple(state.local.X.shape)} on each rank")

    p = Partitioner(folds)
    keys, idx_batch, mask = p.padded_batches()
    (XTWX, XTWY), stats = sharded_training_matrices(
        cfg, state, idx_batch, mask, mesh=mesh
    )
    if XTWX.is_cuda:
        torch.cuda.synchronize(XTWX.device)
    show("fold outputs:", tuple(XTWX.shape),
         "sharding: folds, gathered on every rank")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ranks", type=int, default=2,
                    help="gloo ranks with --device cpu outside torchrun")
    args = ap.parse_args(argv)
    if "WORLD_SIZE" in os.environ:  # under torchrun: join its group
        from cvmatrix_tpu_torch.parallel.multihost import initialize

        initialize(device_type=args.device)
        try:
            mesh_main(make_mesh(args.device))
        finally:
            dist.destroy_process_group()
    elif args.device == "cpu":
        from cvmatrix_tpu_torch.parallel.dryrun import dryrun_multichip

        dryrun_multichip(args.ranks, "cpu", rank_fn=mesh_main)
    else:
        raise SystemExit("run the mesh example on the cards under torchrun, "
                         "or with --device cpu.")


if __name__ == "__main__":
    main()
