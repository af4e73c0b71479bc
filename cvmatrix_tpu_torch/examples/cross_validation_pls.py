"""PLS cross-validation: choose the number of PLS components by every fold's
weighted PRESS (the port's own; the JAX package has no counterpart).

Each fold's PLS model is fitted by Improved Kernel PLS Algorithm #2 from the
fold's training ``XTX`` and ``XTY`` alone, on the device, and only the
(n_folds, n_components, M) PRESS comes back
(``cvmatrix_tpu_torch.cross_validate_pls``). The component count with the
least total PRESS is the one to keep. Fold 0 is checked against the same
fit written out in NumPy on the per-fold engine's matrices.

Run: ``python -m cvmatrix_tpu_torch.examples.cross_validation_pls
[--device cpu]``.
"""

import numpy as np

from cvmatrix_tpu_torch import (
    CVConfig,
    CVMatrix,
    Partitioner,
    cross_validate_pls,
    fit,
)

from ._common import device_arg


def ikpls_coefficients(xtx, xty, n_components):
    """(A, K, M) coefficients of IKPLS Algorithm #2 in NumPy."""
    K, M = xty.shape
    xty = xty.copy()
    P = np.zeros((K, n_components))
    R = np.zeros((K, n_components))
    B = np.zeros((n_components, K, M))
    for a in range(n_components):
        _, vecs = np.linalg.eigh(xty.T @ xty)
        w = xty @ vecs[:, -1:]
        w /= np.linalg.norm(w)
        r = w - R[:, :a] @ (P[:, :a].T @ w)
        t = r.T @ xtx
        tt = float((t @ r)[0, 0])
        p, q = t.T / tt, (r.T @ xty).T / tt
        xty -= (p @ q.T) * tt
        P[:, a:a + 1], R[:, a:a + 1] = p, r
        B[a] = (B[a - 1] if a else 0.0) + r @ q.T
    return B


def main(argv=None) -> None:
    device = device_arg(__doc__, argv)
    rng = np.random.default_rng(3)
    N, K, M, A = 300, 20, 2, 8
    X = rng.uniform(size=(N, K))
    beta = rng.normal(size=(K, M)) * (0.7 ** np.arange(K))[:, None]
    Y = X @ beta + 0.3 * rng.normal(size=(N, M))
    weights = rng.uniform(size=N) + 0.1
    part = Partitioner(np.arange(N) % 7)  # folds of 43 and 42 rows

    config = CVConfig()
    state = fit(config, X, Y, weights, device=device)
    keys, idx, mask = part.padded_batches()
    press = cross_validate_pls(config, state, idx, mask, n_components=A)
    print(f"PRESS: {tuple(press.shape)}  (n_folds, n_components, M)")
    total = press.sum(dim=(0, 2)).cpu().numpy()
    best = int(np.argmin(total)) + 1
    rmsecv = float(np.sqrt(total[best - 1] / weights.sum() / M))
    print(f"best n_components: {best}  (weighted RMSECV {rmsecv:.4f})")

    # Fold 0 again: the per-fold engine's matrices and IKPLS in NumPy.
    val = part.get_validation_indices(keys[0])
    cvm = CVMatrix(device=device).fit(X, Y, weights)
    (xtx, xty), (x_mean, x_std, y_mean, y_std) = cvm.training_XTX_XTY(val)
    B = ikpls_coefficients(xtx.cpu().numpy(), xty.cpu().numpy(), A)
    xv = (X[val] - x_mean.cpu().numpy()) / x_std.cpu().numpy()
    pred = xv @ B * y_std.cpu().numpy() + y_mean.cpu().numpy()
    ref = ((Y[val] - pred) ** 2 * weights[val, None]).sum(axis=1)
    gap = np.abs(press[0].cpu().numpy() - ref).max() / np.abs(ref).max()
    print(f"fold 0, max |sweep - NumPy per-fold| / max PRESS: {gap:.3e}")


if __name__ == "__main__":
    main()
