"""``fit_roofline_pct``: the fit's least time (``costs.fit_cost``: the FP64
product counted once as a symmetric one, X, Y and the weights read once)
over the device time of the operations its span launched, mean over the
traced totals."""

from ..tracing import mean

LAYER = "core.fit"
UNIT = "%"
BETTER = "higher"
MOVES = "folds_per_s"
SOURCE = "device_trace"


def read(rec):
    busy = mean(rec.busy(sp) for sp in rec.spans("fit"))
    if not busy:
        return None
    return 100 * rec.least["fit"] * 1e6 / busy
