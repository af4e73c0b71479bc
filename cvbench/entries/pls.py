"""``pls``: PLS cross-validation on the port,
``cvmatrix_tpu_torch.models.pls.cross_validate_pls``: Improved Kernel PLS
Algorithm #2 fitted on every fold's training matrices, and each fold's
validation rows scored by their weighted PRESS for 1..A components. One call
a bucket of folds of one size, in chunks of ``batch_size``; the caller gets
(P, A, M). The folds checked are copied out of it. The module imports
``models.pls`` when it loads, so a tree without it fails at once."""

from __future__ import annotations

import numpy as np

from cvmatrix_tpu_torch.models import pls

from .. import pls_costs, reference_pls
from ..compare import gap

NUMBERS = ("pls_rel_err",)

# The least seconds of one total's PLS work (``pls_costs``), set by each
# run; the ``pls_roofline_pct`` reader takes it from here.
LEAST_PLS_S = None


def run(ctx, state, sample, span):
    """Every fold of the cell through the PLS sweep; returns the checked
    folds' PRESS, ``{fold: {"press"}}``."""
    global LEAST_PLS_S
    n_components = ctx.cfg["n_components"]
    kept = {}
    for b in ctx.folds.buckets:
        with span("cvbench.pls"):
            out = pls.cross_validate_pls(
                ctx.config, state, b.idx, b.mask, n_components=n_components,
                batch_size=ctx.cell["batch_size"])
        for p in sample.folds:
            pos = int(np.searchsorted(b.folds, p))
            if pos < len(b.folds) and b.folds[pos] == p:
                kept[p] = {"press": out[pos].clone()}
    ctx.out_values = n_components * ctx.cfg["M"]
    LEAST_PLS_S = pls_costs.least_seconds(ctx.cfg, ctx.folds.shapes())[0]
    return kept


def judge(ctx, p, out, X, Y, w, rows):
    """The fold's (A, M) PRESS against the reference's: the widest gap over
    the reference's largest PRESS of the fold."""
    del rows
    ref = reference_pls.fold_press(X, Y, w, ctx.folds.rows(p), ctx.cfg)
    return {"pls_rel_err": gap(out["press"], ref)}
