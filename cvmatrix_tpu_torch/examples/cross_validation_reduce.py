"""Device-resident cross-validation: matrices consumed on the device (the
JAX package's ``examples/cross_validation_reduce.py``).

Every fold's (K, K) / (K, M) training matrices are consumed where they are
produced: the sweep maps a user reduction (here a ridge solve for per-fold
regression coefficients, the downstream step of PLS/ridge-style pipelines)
over each chunk of folds, and only the coefficients come back. The JAX
example solves in float32 because the TPU has no float64 LU; the H100 has
native float64, so the port solves in float64.

Run: ``python -m cvmatrix_tpu_torch.examples.cross_validation_reduce
[--device cpu]``.
"""

import numpy as np
import torch

from cvmatrix_tpu_torch import CVMatrix, Partitioner

from ._common import device_arg

LAM = 1e-6


def ridge_coefficients(mats, stats):
    """Per-fold reduction, run under ``torch.func.vmap`` over each chunk."""
    xtx, xty = mats
    lhs = xtx + LAM * torch.eye(xtx.shape[0], dtype=xtx.dtype,
                                device=xtx.device)
    return torch.linalg.solve(lhs, xty)


def main(argv=None) -> None:
    device = device_arg(__doc__, argv)
    rng = np.random.default_rng(7)
    N, K, M = 600, 40, 2
    X = rng.uniform(size=(N, K))
    beta_true = rng.normal(size=(K, M))
    Y = X @ beta_true + 0.01 * rng.normal(size=(N, M))
    weights = rng.uniform(size=N) + 0.1
    folds = np.arange(N) % 7

    cvm = CVMatrix(center_X=True, center_Y=True, scale_X=True, scale_Y=True,
                   device=device)
    cvm.fit(X, Y, weights)
    p = Partitioner(folds)

    keys, coefs = cvm.cross_validate_reduce(p, reduce_fn=ridge_coefficients)
    print(f"per-fold coefficients: {tuple(coefs.shape)}  (n_folds, K, M)")

    # Cross-check fold 0 against the eager per-fold path.
    (xtx0, xty0), _ = cvm.training_XTX_XTY(p.get_validation_indices(keys[0]))
    ref = np.linalg.solve(xtx0.cpu().numpy() + LAM * np.eye(K),
                          xty0.cpu().numpy())
    print("max |sweep - eager solve|:",
          float(np.max(np.abs(coefs[0].cpu().numpy() - ref))))


if __name__ == "__main__":
    main()
