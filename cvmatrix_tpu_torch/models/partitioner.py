"""Fold -> validation-index bookkeeping (Algorithm 1) plus batching.

Counterpart of :class:`cvmatrix_tpu.models.partitioner.Partitioner`, with the
same behaviour: it is host bookkeeping on NumPy arrays and imports neither
JAX nor torch. Integer fold labels group through the repository's native
``csrc/fastpartition.cpp`` (built by :mod:`cvmatrix_tpu_torch.native`), other
labels through a vectorised NumPy path or the reference's dict loop.

Beyond the reference's surface (``folds_dict``, ``get_validation_indices``,
ValueError on unknown folds):

- :meth:`size_buckets` — folds grouped by validation-set size, one fixed
  ``(F, L)`` shape per bucket.
- :meth:`padded_batches` — all folds padded to one length with a 0/1 mask.
- :meth:`validate` — the host-side pre-flight that rejects degenerate folds
  and out-of-range indices before a batched kernel runs.

This class is deliberately detached from the engine and holds only host
numpy data.
"""

from __future__ import annotations

from collections import defaultdict
from collections.abc import Hashable
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

__all__ = ["Partitioner"]


class Partitioner:
    """Maps each fold identifier to its validation-row indices.

    >>> import numpy as np
    >>> p = Partitioner(np.array([0, 1, 0, 2, 1, 0]))
    >>> p.get_validation_indices(0)
    array([0, 2, 5])
    >>> sorted(int(k) for k in p.folds_dict)
    [0, 1, 2]
    """

    def __init__(self, folds: Iterable[Hashable]) -> None:
        self.folds_dict: Dict[Hashable, np.ndarray] = self._build(folds)

    # ------------------------------------------------------------------ #
    # Reference-parity surface                                            #
    # ------------------------------------------------------------------ #

    def get_validation_indices(self, fold: Hashable) -> np.ndarray:
        """Integer indices of the validation rows for ``fold``.

        Raises ``ValueError`` for unknown folds (ref ``partitioner.py:83-87``).
        """
        try:
            return self.folds_dict[fold]
        except KeyError as e:
            raise ValueError(f"Fold {fold} not found.") from e

    @staticmethod
    def _build(folds: Iterable[Hashable]) -> Dict[Hashable, np.ndarray]:
        if (
            isinstance(folds, np.ndarray)
            and folds.ndim == 1
            and folds.dtype.kind in "iu"
        ):
            # Native O(N) single-pass grouping (ctypes -> csrc/fastpartition.cpp);
            # preserves first-appearance key order like the reference's dict.
            from ..native import partition_int64

            res = partition_int64(folds)
            if res is not None:
                keys, groups = res
                return {
                    folds.dtype.type(k): np.asarray(g, dtype=int)
                    for k, g in zip(keys, groups)
                }
        # The vectorised path requires np.unique to agree with dict-keyed
        # grouping: object arrays can hold mutually-uncomparable labels
        # (unique's sort raises where the reference dict loop succeeds),
        # and unique collapses all NaNs into ONE fold (equal_nan) where
        # the reference's dict makes each NaN row its own fold — both fall
        # through to the generic loop below.
        vectorizable = (
            isinstance(folds, np.ndarray)
            and folds.ndim == 1
            and folds.dtype != object
            and not (np.issubdtype(folds.dtype, np.floating)
                     and bool(np.isnan(folds).any()))
        )
        if vectorizable:
            # Vectorised path: sort once, split by fold, order keys by first
            # appearance (matching the reference's insertion-order dict).
            keys, first_idx, inverse = np.unique(
                folds, return_index=True, return_inverse=True
            )
            order = np.argsort(inverse, kind="stable")
            counts = np.bincount(inverse, minlength=len(keys))
            splits = np.split(order, np.cumsum(counts)[:-1])
            by_first = np.argsort(first_idx, kind="stable")
            return {
                keys[i]: np.asarray(splits[i], dtype=int) for i in by_first
            }
        acc: defaultdict = defaultdict(list)
        for i, f in enumerate(folds):
            acc[f].append(i)
        return {k: np.asarray(ix, dtype=int) for k, ix in acc.items()}

    # ------------------------------------------------------------------ #
    # Batching surface                                                    #
    # ------------------------------------------------------------------ #

    @property
    def num_folds(self) -> int:
        return len(self.folds_dict)

    def fold_sizes(self) -> Dict[Hashable, int]:
        return {k: v.size for k, v in self.folds_dict.items()}

    def size_buckets(self) -> List[Tuple[List[Hashable], np.ndarray]]:
        """Folds grouped by size: ``[(fold_keys, (F_b, L_b) index batch)]``.

        Each bucket has one fixed shape, so the batched fold engine takes it
        as one ``(F, L)`` index tensor.
        """
        buckets: defaultdict = defaultdict(list)
        for k, v in self.folds_dict.items():
            buckets[v.size].append(k)
        out = []
        for size, ks in buckets.items():
            batch = np.stack([self.folds_dict[k] for k in ks])
            out.append((ks, batch))
        return out

    def padded_batches(
        self, pad_to: Optional[int] = None
    ) -> Tuple[List[Hashable], np.ndarray, Optional[np.ndarray]]:
        """All folds as one ``(F, L)`` batch, zero-padded, plus a 0/1 mask.

        Padded slots carry index 0 and mask 0 (the engine's ``mask`` argument
        zeroes their contribution exactly). When all folds share one size the
        mask is ``None`` — the batched engine then skips the masking work.
        """
        keys = list(self.folds_dict.keys())
        sizes = np.array([self.folds_dict[k].size for k in keys])
        length = int(sizes.max()) if pad_to is None else int(pad_to)
        if (sizes > length).any():
            raise ValueError(
                f"pad_to={length} is smaller than the largest fold "
                f"({int(sizes.max())} rows)."
            )
        if (sizes == length).all():
            return keys, np.stack([self.folds_dict[k] for k in keys]), None
        idx = np.zeros((len(keys), length), dtype=int)
        mask = np.zeros((len(keys), length), dtype=np.float64)
        for i, k in enumerate(keys):
            v = self.folds_dict[k]
            idx[i, : v.size] = v
            mask[i, : v.size] = 1.0
        return keys, idx, mask

    # ------------------------------------------------------------------ #
    # Host-side pre-flight                                                #
    # ------------------------------------------------------------------ #

    def validate(
        self,
        n_samples: int,
        weights: Optional[np.ndarray] = None,
        *,
        ddof: int = 1,
        needs_stats: bool = False,
        needs_std: bool = False,
    ) -> None:
        """Eagerly reject degenerate folds before a batched kernel runs.

        Re-creates, per fold, the data-dependent ValueErrors that the
        batched kernel routes do not check (ref
        ``cvmatrix/cvmatrix.py:625-629, 1074-1078``):
        a training set with zero non-zero weights (when any statistic is
        computed) or with ``ddof >=`` its non-zero-weight count (when any
        std is computed). Also rejects out-of-range indices. The ``ddof``
        default matches :class:`~cvmatrix_tpu_torch.config.CVConfig`'s (1) —
        pass the config's actual value when it differs.
        """
        w = None if weights is None else np.asarray(weights).reshape(-1)
        total_nnz = n_samples if w is None else int(np.count_nonzero(w))
        for k, v in self.folds_dict.items():
            if v.size and (v.min() < 0 or v.max() >= n_samples):
                raise ValueError(
                    f"Fold {k} has validation indices outside [0, {n_samples})."
                )
            nnz_val = v.size if w is None else int(np.count_nonzero(w[v]))
            nnz_train = total_nnz - nnz_val
            if needs_stats and nnz_train == 0:
                raise ValueError(
                    "The number of non-zero weights in the training set must "
                    f"be greater than zero (fold {k})."
                )
            if needs_std and nnz_train <= ddof:
                raise ValueError(
                    "The number of non-zero weights in the training set must "
                    f"be greater than `ddof` (fold {k})."
                )
