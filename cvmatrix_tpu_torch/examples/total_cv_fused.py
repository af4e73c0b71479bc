"""Total CV: fit + every fold's matrices in one call (the JAX package's
``examples/total_cv_fused.py``).

``materialize_cv`` is the throughput primitive behind the headline
benchmark (the reference measures fit + all folds' training matrices as
one quantity): the fit, then the whole fold sweep through the CUDA
kernels, chunk by chunk into one reused buffer. Where the JAX package
compiles one program, the port queues eager launches with no host
round trip between them.

The returned value is a probe scalar whose read waits for everything; use
``materialize_sweep`` / ``cross_validate_reduce`` when you need the
per-fold results themselves.

Run: ``python -m cvmatrix_tpu_torch.examples.total_cv_fused [--device
cpu]``.
"""

import time

import numpy as np

from cvmatrix_tpu_torch import CVConfig
from cvmatrix_tpu_torch.models.sweep import materialize_cv

from ._common import device_arg

N, K, M, P = 20_000, 64, 4, 100


def main(argv=None) -> None:
    device = device_arg(__doc__, argv)
    rng = np.random.default_rng(0)
    X = rng.random((N, K))
    Y = rng.random((N, M))
    weights = rng.random(N)
    cfg = CVConfig(center_X=True, center_Y=True, scale_X=True, scale_Y=True,
                   ddof=1, dtype=np.float64)

    # Equal-size folds stack directly; use Partitioner.padded_batches() for
    # unequal folds (pass its mask as mask_batch).
    idx_batch = np.stack([np.where(np.arange(N) % P == f)[0]
                          for f in range(P)])

    def total():
        return float(materialize_cv(cfg, X, Y, weights, idx_batch,
                                    device=device))

    probe = total()  # warm-up: the kernels' first load
    t0 = time.perf_counter()
    probe = total()
    dt = time.perf_counter() - t0
    print(f"total CV (fit + {P} folds) in one call: {dt:.4f}s "
          f"({P / dt:,.0f} folds/s), probe={probe:.6g}")


if __name__ == "__main__":
    main()
