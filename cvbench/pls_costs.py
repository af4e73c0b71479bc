"""The least work of one total's PLS cross-validation, the yardstick of
``pls_roofline_pct``.

FLOPs: per fold and component, ``2 K^2 + 6 K M``: the product ``r^T XTX``
(2 K^2) and the K x M passes of the eigen-matrix ``XTY^T XTY``, ``XTY q``,
``XTY^T r`` and the deflation (about 6 K M); the Jacobi rotations, the
Gram-Schmidt step and the validation rows' scores are left out, so the
count is low, never high. Bytes: the fitted ``[XTX | XTY]`` read once, each
fold's validation rows (K + M values and a weight) read once, and each
fold's (A, M) PRESS written once. The folds' training matrices are not
counted: a design that never forms them (``XTX_f r`` from the fitted total
and the fold's rank-one corrections) need never read them, so no design can
read over 100%. Peaks as ``costs.py``: 3.35 TB/s, 67 TFLOP/s FP64.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from .costs import least_seconds as _least


def pls_cost(shapes: Iterable[Tuple[int, int]], k: int, m: int, a: int,
             item: int, weighted: bool) -> Tuple[int, int]:
    """Bytes and FLOPs of every fold's PLS solve and score: ``shapes`` lists
    ``(F, L)`` of each bucket of F folds of L validation rows."""
    nbytes = k * (k + m)
    flops = 0
    for f, n_l in shapes:
        nbytes += f * n_l * (k + m + int(weighted)) + f * a * m
        flops += f * a * (2 * k * k + 6 * k * m)
    return item * nbytes, flops


def least_seconds(cfg: dict, shapes) -> Tuple[float, str]:
    """``(seconds, "bytes" | "flops")`` of one total's PLS work for the
    configuration ``cfg`` over the fold ``shapes``."""
    item = 8 if cfg["dtype"] == "float64" else 4
    return _least(*pls_cost(shapes, cfg["K"], cfg["M"], cfg["n_components"],
                            item, cfg["weighted"]))
