"""The one generator of the benchmark's traffic: a cell's fold batches, its
inputs and the folds each total hands to the check, all from data files and
the seed.

A cell (``workloads/<cell>.json``) names its configuration and a fold
scheme: ``P`` folds over N rows, fold ``p`` holding the rows ``r`` with
``r % P == p`` (``Partitioner(np.arange(N) % P)``), and the ``batch_size``
of the chunks its entry runs them in. Folds of one size form a bucket, as
``sm00thix/cvmatrix`` ``benchmarks/benchmark.py`` buckets them, and each
bucket is cut into chunks in order; with ``"masked": true`` every fold is
padded to the largest size instead, as one (P, L) batch with a 0/1 mask.

The inputs follow ``bench.py``'s recipe (``cvmatrix_tpu_torch/bench.py``
``bench_data``: X, Y and the weights uniform on [0, 1), drawn in float64 and
cast to the configuration's dtype), moved onto the card: one
``torch.Generator`` on the device, seeded from ``--seed``, makes each
array in one call. The weights are drawn anew before every total from
(seed, total index), so no two totals repeat their inputs and every total
pays a full fit.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

# Streams of the seed: the data, the weights of each total, the samples.
_DATA, _WEIGHTS, _SAMPLES = 0, 1, 2
# The fit's rows compared each total, and the rows of a fold compared where
# K is wider than FULL_ROWS (all rows are compared up to it).
FIT_ROWS = 16
FULL_ROWS = 1024
WIDE_ROWS = 64
# Totals a window is expected to hold at the least: a run checks enough
# folds a total that this many totals reach every chunk.
CHECK_TOTALS = 100


def derive(seed: int, *keys: int) -> int:
    """A 63-bit seed for torch from ``seed`` (any integer) and ``keys``."""
    ss = np.random.SeedSequence([seed % 2 ** 64, *keys])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def inputs(cfg: dict, seed: int, device: torch.device):
    """X (N, K) and Y (N, M) of the configuration, uniform on [0, 1)."""
    g = _generator(device, derive(seed, _DATA))
    dtype = getattr(torch, cfg["dtype"])
    X = torch.rand((cfg["N"], cfg["K"]), generator=g, dtype=torch.float64,
                   device=device).to(dtype)
    Y = torch.rand((cfg["N"], cfg["M"]), generator=g, dtype=torch.float64,
                   device=device).to(dtype)
    return X, Y


def weights(cfg: dict, seed: int, total: int, device: torch.device):
    """The weights of total ``total`` (-1: the warm-up's), or ``None`` for
    an unweighted configuration."""
    if not cfg["weighted"]:
        return None
    g = _generator(device, derive(seed, _WEIGHTS, total + 1))
    return torch.rand(cfg["N"], generator=g, dtype=torch.float64,
                      device=device).to(getattr(torch, cfg["dtype"]))


class Chunk(NamedTuple):
    idx: np.ndarray            # (F, L) fold rows
    mask: Optional[np.ndarray]  # (F, L) 0/1, or None
    folds: np.ndarray          # (F,) fold ids


class Folds:
    """The fold scheme of a cell over N rows: its buckets (one per fold
    size, or one masked batch), their chunks, and where each fold lies."""

    def __init__(self, n: int, P: int, batch_size: int,
                 masked: bool = False) -> None:
        if not 1 <= P <= n:
            raise ValueError(f"P={P} folds over N={n} rows")
        self.n, self.P = n, P
        sizes = (n - np.arange(P) + P - 1) // P  # fold p: rows p, p+P, ...
        groups = ([np.arange(P)] if masked else
                  [np.flatnonzero(sizes == s) for s in np.unique(sizes)[::-1]])
        self.buckets: List[Chunk] = []
        for ids in groups:
            L = int(sizes[ids].max())
            idx = ids[:, None] + P * np.arange(L)[None, :]
            mask = None
            if masked:
                mask = (idx < n).astype(np.float64)
                idx = np.where(idx < n, idx, ids[:, None])
            self.buckets.append(Chunk(idx.astype(np.int64), mask, ids))
        self.chunks = [
            Chunk(b.idx[s:s + batch_size],
                  None if b.mask is None else b.mask[s:s + batch_size],
                  b.folds[s:s + batch_size])
            for b in self.buckets for s in range(0, len(b.folds), batch_size)]
        self.where: Dict[int, tuple] = {}
        for c, ch in enumerate(self.chunks):
            for pos, p in enumerate(ch.folds):
                self.where[int(p)] = (c, pos)

    def rows(self, p: int) -> np.ndarray:
        """The validation rows of fold ``p``."""
        return np.arange(p, self.n, self.P)

    def shapes(self) -> List[tuple]:
        """``(F, L)`` of each bucket: the folds the cell computes."""
        return [b.idx.shape for b in self.buckets]


class Sample(NamedTuple):
    folds: List[int]           # fold ids checked in this total
    rows: List[np.ndarray]     # their XTX rows compared
    fit_rows: np.ndarray       # the fit's XTX rows compared


def sample(cfg: dict, folds: Folds, seed: int, total: int) -> Sample:
    """What total ``total`` hands to the check, drawn from (seed, total):
    folds from chunks taken in turn, so that a window of CHECK_TOTALS totals
    reaches every chunk, one fold at random in each; their rows (all up to
    FULL_ROWS, else WIDE_ROWS at random); and FIT_ROWS rows of the fit."""
    n_chunks = len(folds.chunks)
    start = int(np.random.default_rng(np.random.SeedSequence(
        [seed % 2 ** 64, _SAMPLES])).integers(n_chunks))
    rng = np.random.default_rng(
        np.random.SeedSequence([seed % 2 ** 64, _SAMPLES, total + 1]))
    K = cfg["K"]
    per_total = math.ceil(n_chunks / CHECK_TOTALS)
    picked, rows = [], []
    for j in range(per_total):
        ch = folds.chunks[(start + total * per_total + j) % n_chunks]
        picked.append(int(ch.folds[rng.integers(len(ch.folds))]))
        rows.append(np.arange(K) if K <= FULL_ROWS else
                    np.sort(rng.choice(K, WIDE_ROWS, replace=False)))
    fit_rows = np.sort(rng.choice(K, min(FIT_ROWS, K), replace=False))
    return Sample(picked, rows, fit_rows)
