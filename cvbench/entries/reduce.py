"""``reduce``: the port's own user sweep,
``cvmatrix_tpu_torch.models.sweep.cross_validate_reduce``, which maps the
cell's reduction over every fold in chunks of ``batch_size`` and keeps only
the reductions. One call a bucket of folds of one size. The folds checked
are copied out of the kept reductions."""

from __future__ import annotations

import numpy as np

from cvmatrix_tpu_torch.models import sweep

from .. import reference

NUMBERS = ("reduce_rel_err",)


def run(ctx, state, sample, span):
    """Every fold of the cell through the reduce sweep; returns the checked
    folds' reductions, ``{fold: {"out"}}``."""
    kept = {}
    for b in ctx.folds.buckets:
        with span("cvbench.reduce"):
            out = sweep.cross_validate_reduce(
                ctx.config, state, b.idx, b.mask,
                reduce_fn=ctx.reduction.reduce,
                batch_size=ctx.cell["batch_size"])
        ctx.out_values = out[0].numel()
        for p in sample.folds:
            pos = int(np.searchsorted(b.folds, p))
            if pos < len(b.folds) and b.folds[pos] == p:
                kept[p] = {"out": out[pos].clone()}
    return kept


def judge(ctx, p, out, X, Y, w, rows):
    """The fold's reduction against the reduction of the reference's whole
    fold matrices."""
    del rows
    xtx, xty, stats = reference.fold(X, Y, w, ctx.folds.rows(p), ctx.cfg)
    ref = ctx.reduction.reduce((xtx, xty), stats)
    return {"reduce_rel_err": ctx.reduction.judge(
        out["out"], ref.cpu(), ctx.cfg["K"], ctx.cfg["M"])}
