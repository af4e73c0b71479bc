"""Mesh layer: row-sharded fit and fold-sharded training matrices.

SPMD entry points on ``torch.distributed`` re-exported from
:mod:`cvmatrix_tpu_torch.parallel.distributed`; process-group plumbing
lives in :mod:`cvmatrix_tpu_torch.parallel.multihost`, and a small sharded
run over spawned ranks in :mod:`cvmatrix_tpu_torch.parallel.dryrun`.
"""

from .distributed import (
    fit_sharded,
    make_mesh,
    sharded_cross_validate_reduce,
    sharded_training_matrices,
)

__all__ = [
    "fit_sharded",
    "make_mesh",
    "sharded_cross_validate_reduce",
    "sharded_training_matrices",
]
