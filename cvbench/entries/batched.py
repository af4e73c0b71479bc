"""``batched``: the pattern ``sm00thix/cvmatrix`` ``benchmarks/benchmark.py``
times (lines 136-152). One fit, then one
``cvmatrix_tpu_torch.core.batch.training_matrices_batched`` call a chunk of
``batch_size`` folds, in order; the caller gets every fold's XTX, XTY and
statistics. The folds checked are copied out of their chunk's output as the
chunk returns."""

from __future__ import annotations

import numpy as np

from cvmatrix_tpu_torch.core import batch

from .. import reference
from ..compare import gap

NUMBERS = ("fold_rel_err", "stats_rel_err")


def _take(t, pos, rows):
    return t[pos].clone() if rows is None else t[pos].index_select(0, rows)


def run(ctx, state, sample, span):
    """Every chunk of the cell through the batched entry; returns the
    checked folds' outputs, ``{fold: {"XTX", "XTY", "stats"}}``."""
    want = {}
    for p, rows in zip(sample.folds, sample.rows):
        c, pos = ctx.folds.where[p]
        want.setdefault(c, []).append((p, pos, rows))
    kept = {}
    for c, ch in enumerate(ctx.folds.chunks):
        with span("cvbench.chunk"):
            (xtx, xty), stats = batch.training_matrices_batched(
                ctx.config, state, ch.idx, ch.mask)
        if c == 0:
            ctx.out_values = (xtx[0].numel() + xty[0].numel() + sum(
                s[0].numel() for s in stats if s is not None))
        for p, pos, rows in want.get(c, ()):
            kept[p] = {"XTX": _take(xtx, pos, rows),
                       "XTY": _take(xty, pos, rows),
                       "stats": [None if s is None else s[pos].clone()
                                 for s in stats]}
    return kept


def judge(ctx, p, out, X, Y, w, rows):
    """The fold's numbers against the reference's rows ``rows``."""
    xtx, xty, stats = reference.fold(X, Y, w, ctx.folds.rows(p), ctx.cfg,
                                     None if rows is None else np.asarray(
                                         rows.cpu()))
    return {"fold_rel_err": max(gap(out["XTX"], xtx), gap(out["XTY"], xty)),
            "stats_rel_err": max([gap(a, b) for a, b in zip(out["stats"],
                                                             stats)
                                  if a is not None and b is not None],
                                 default=0.0)}
