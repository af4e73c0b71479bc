"""``pls_wide_ms``: device time of the operations whose name holds
``ikpls2_wide`` (the wide route's PLS solve: its transpose, products and
steps) among those launched in the folds' span, summed a total, mean over
the traced totals; ``None`` where no such operation ran (a program without
the wide route)."""

from ..tracing import mean

LAYER = "models.pls"
UNIT = "ms"
BETTER = "lower"
MOVES = "folds_per_s"
SOURCE = "device_trace"


def read(rec):
    per_total, found = [], False
    for sp in rec.spans("folds"):
        ops = [o for o in rec.ops_in(sp) if "ikpls2_wide" in o[2]]
        found = found or bool(ops)
        per_total.append(sum(e - s for s, e, _ in ops) / 1e3)
    return mean(per_total) if found else None
