"""``colstats``: the column sums and the column largest magnitudes of each
fold's XTX and XTY, 2 (K + M) numbers a fold.

The largest magnitudes admit no algebraic shortcut, so the fold's whole
product has to be formed. It reads each entry twice in plain torch, once a
reduction (the largest magnitude as the infinity norm of a column, which
makes no copy of |XTX|). It stands in for the first pass of any per-fold
model fit (a PLS or ridge fit reads every entry of both matrices).
"""

from __future__ import annotations

import torch

# The reduction needs every entry of the fold's product.
EVERY_ENTRY = True


def reduce(mats, stats):
    """One fold's ``(XTX, XTY)`` -> (2 (K + M),): [sum over rows of XTX,
    of XTY, largest |.| over rows of XTX, of XTY]."""
    del stats
    xtx, xty = mats
    return torch.cat([xtx.sum(0), xty.sum(0),
                      torch.linalg.vector_norm(xtx, float("inf"), dim=0),
                      torch.linalg.vector_norm(xty, float("inf"), dim=0)])


def judge(out: torch.Tensor, ref: torch.Tensor, k: int, m: int) -> float:
    """The widest gap of ``out`` from ``ref``, each of the four parts against
    the largest magnitude of that part of ``ref``."""
    worst = 0.0
    for s, e in ((0, k), (k, k + m), (k + m, 2 * k + m),
                 (2 * k + m, 2 * (k + m))):
        gap = float((out[s:e] - ref[s:e]).abs().max())
        scale = max(float(ref[s:e].abs().max()), 1e-300)
        worst = max(worst, gap / scale if gap == gap else float("inf"))
    return worst
