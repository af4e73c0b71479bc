"""``reduce_sweep_ms``: host time of ``models.sweep.cross_validate_reduce``
a total, from the start of the folds' span to the ``synchronize()`` that
ends it, mean over the traced totals. Read in the cells whose entry is
``reduce``."""

from ..tracing import mean

LAYER = "models.sweep"
UNIT = "ms"
BETTER = "lower"
MOVES = "folds_per_s"
SOURCE = "program_span"


def read(rec):
    if rec.entry != "reduce":
        return None
    return mean((e - s) / 1e3 for s, e in rec.spans("folds"))
