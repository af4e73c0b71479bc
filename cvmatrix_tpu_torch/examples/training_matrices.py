"""Eager per-fold walkthrough (the JAX package's
``examples/training_matrices.py``): fit once, then query each fold's
training matrices and statistics.

Run: ``python -m cvmatrix_tpu_torch.examples.training_matrices [--device
cpu]``.
"""

import numpy as np

from cvmatrix_tpu_torch import CVMatrix, Partitioner

from ._common import device_arg


def main(argv=None) -> None:
    device = device_arg(__doc__, argv)
    rng = np.random.default_rng(42)
    N, K, M = 100, 50, 10
    X = rng.uniform(size=(N, K))
    Y = rng.uniform(size=(N, M))
    weights = rng.uniform(size=(N,)) + 0.1  # non-negative
    folds = np.arange(N) % 5

    cvm = CVMatrix(center_X=True, center_Y=True, scale_X=True, scale_Y=True,
                   device=device)
    cvm.fit(X=X, Y=Y, weights=weights)
    p = Partitioner(folds=folds)

    for fold in p.folds_dict:
        val_indices = p.get_validation_indices(fold)

        # Both matrices + weighted statistics:
        (XTWX, XTWY), (X_mean, X_std, Y_mean, Y_std) = cvm.training_XTX_XTY(
            val_indices
        )
        print(f"fold {fold}: XTWX {tuple(XTWX.shape)}, XTWY "
              f"{tuple(XTWY.shape)}")

        # Only XTWX (Y statistics are None):
        XTWX_only, stats = cvm.training_XTX(val_indices)

        # Only XTWY:
        XTWY_only, stats = cvm.training_XTY(val_indices)

        # Statistics alone:
        X_mean, X_std, Y_mean, Y_std = cvm.training_statistics(val_indices)

    # Refitting replaces all state (same semantics as the reference).
    cvm.fit(X=Y, Y=X, weights=None)
    print("refit OK:", tuple(cvm.XTX.shape))


if __name__ == "__main__":
    main()
