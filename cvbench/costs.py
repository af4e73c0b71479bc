"""The least work of a cell's fit and folds, and the least time the card
could take for it: the yardstick of the roofline shares.

Frozen copy of ``chip_smoke.py``'s ``bound`` and ``fold_cost`` (PRs 4-9),
changed so that the counts read the same work whatever implements it, and no
implementation can read over 100%:

- the product of a fold is counted once as a symmetric product,
  L K (K + 1) + 2 L K M FLOPs (``fold_cost`` counted the full K x C product
  unless told the kernel was symmetric, and four epilogue FLOPs an entry);
- a fold row is read once with its weight, and its index is not counted
  (``fold_cost`` added an int64 index where a kernel gathers);
- ``epilogue_cost`` is gone: a product read and rewritten in place is a cost
  of one implementation, not of the work;
- the outputs are what the entry hands back: each fold's matrices and
  statistics where they are materialised, or the reductions alone where a
  reduction consumes them (they need never be written), and the fold
  product is counted there only where the reduction reads every entry.

Peaks: NVIDIA's published H100 SXM figures, 3.35 TB/s of HBM and 67 TFLOP/s
of FP64 on the tensor cores. A run prints the card's power limit beside
them.
"""

from __future__ import annotations

from typing import Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 67e12


def least_seconds(nbytes: float, flops: float) -> Tuple[float, str]:
    """``(seconds, "bytes" | "flops")``: the larger of ``nbytes`` at the HBM
    peak and ``flops`` at the FP64 peak, and which one bounds."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_flops = flops / PEAK_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "flops")


def _stats_values(k: int, m: int) -> int:
    """The fitted sums: sum_X, sum_sq_X (K each), sum_Y, sum_sq_Y (M each)
    and sum_w."""
    return 2 * (k + m) + 1


def fit_cost(n: int, k: int, m: int, item: int,
             weighted: bool) -> Tuple[int, int]:
    """Bytes and FLOPs of the fit: X, Y and the weights read once, [XTX |
    XTY] (K, K + M) and the sums written once; XTX as a symmetric product,
    N K (K + 1) + 2 N K M FLOPs."""
    nbytes = item * (n * (k + m + int(weighted)) + k * (k + m)
                     + _stats_values(k, m))
    return nbytes, n * k * (k + 1) + 2 * n * k * m


def folds_cost(shapes: Iterable[Tuple[int, int]], k: int, m: int, item: int,
               weighted: bool, out_values: int,
               every_entry: bool = True) -> Tuple[int, int]:
    """Bytes and FLOPs of every fold of a total: ``shapes`` lists ``(F, L)``
    of each bucket of F folds of L rows. Read once: the fitted [XTX | XTY]
    and sums, and each fold row (K + M values and its weight). Written once:
    ``out_values`` values a fold, what the entry hands back. FLOPs: each
    fold's symmetric product, L K (K + 1) + 2 L K M, where the output needs
    every entry of it (``every_entry``)."""
    nbytes = k * (k + m) + _stats_values(k, m)
    flops = 0
    for f, n_l in shapes:
        nbytes += f * n_l * (k + m + int(weighted)) + f * out_values
        if every_entry:
            flops += f * (n_l * k * (k + 1) + 2 * n_l * k * m)
    return item * nbytes, flops
