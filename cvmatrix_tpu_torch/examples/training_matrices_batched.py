"""Batched folds in one call: the port's fast path (the JAX package's
``examples/training_matrices_batched.py``).

Where the JAX example compiles ``jax.jit(jax.vmap(...))`` over a stacked
fold batch, the port passes the (F, L) batch to
:func:`cvmatrix_tpu_torch.core.batch.training_matrices_batched`, which
sends it through the hand-written CUDA kernels on the card (their plain
twins on the CPU); unequal folds go in as one padded batch with a mask.

Run: ``python -m cvmatrix_tpu_torch.examples.training_matrices_batched
[--device cpu]``.
"""

import numpy as np

from cvmatrix_tpu_torch import CVMatrix, Partitioner
from cvmatrix_tpu_torch.core.batch import training_matrices_batched

from ._common import device_arg


def main(argv=None) -> None:
    device = device_arg(__doc__, argv)
    rng = np.random.default_rng(42)
    N, K, M = 100, 10, 3
    X = rng.uniform(size=(N, K))
    Y = rng.uniform(size=(N, M))
    weights = rng.uniform(size=(N,)) + 0.1

    # --- equal-size folds: plain stacked batch --------------------------
    folds = np.arange(N) % 5
    cvm = CVMatrix(center_X=True, center_Y=True, scale_X=True, scale_Y=True,
                   device=device)
    cvm.fit(X, Y, weights)
    p = Partitioner(folds)
    keys, idx_batch, mask = p.padded_batches()
    assert mask is None  # equal folds -> no mask needed

    def batched(idx, mask=None):
        return training_matrices_batched(cvm.config, cvm.state, idx, mask)

    (XTWX, XTWY), (X_mean, X_std, Y_mean, Y_std) = batched(idx_batch)
    print(f"folds: {keys}")
    print(f"batched XTWX: {tuple(XTWX.shape)}  (n_folds, K, K)")
    print(f"batched XTWY: {tuple(XTWY.shape)}  (n_folds, K, M)")

    # Cross-check fold 0 against the eager path.
    (XTWX0, XTWY0), _ = cvm.training_XTX_XTY(p.get_validation_indices(keys[0]))
    print("max |batched - eager|:", float((XTWX[0] - XTWX0).abs().max()))

    # --- unequal folds: padded + masked, still ONE call ------------------
    folds = np.concatenate([np.zeros(17), np.ones(33), np.full(50, 2.0)])
    cvm.fit(X, Y, weights)
    p = Partitioner(folds)
    keys, idx_batch, mask = p.padded_batches()
    (XTWX, XTWY), _ = batched(idx_batch, mask)
    (ref, _), _ = cvm.training_XTX_XTY(p.get_validation_indices(keys[0]))
    print("masked batch vs eager:", float((XTWX[0] - ref).abs().max()))


if __name__ == "__main__":
    main()
