"""``fold_roofline_pct``: the least time of one total's folds
(``costs.folds_cost``: what the entry hands back written once, each fold
row read once, each fold's product counted once as a symmetric one) over the
device time of every operation launched in the folds' span (the batched
chunks, or the reduce sweep with its reduction), mean over the traced
totals."""

from ..tracing import mean

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
MOVES = "folds_per_s"
SOURCE = "device_trace"


def read(rec):
    busy = mean(rec.busy(sp) for sp in rec.spans("folds"))
    if not busy:
        return None
    return 100 * rec.least["folds"] * 1e6 / busy
