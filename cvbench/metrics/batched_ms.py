"""``batched_ms``: host time of every ``core.batch.training_matrices_batched``
chunk call of a total, from the start of the folds' span to the
``synchronize()`` that ends it, mean over the traced totals. Read in the
cells whose entry is ``batched``."""

from ..tracing import mean

LAYER = "core.batch"
UNIT = "ms"
BETTER = "lower"
MOVES = "folds_per_s"
SOURCE = "program_span"


def read(rec):
    if rec.entry != "batched":
        return None
    return mean((e - s) / 1e3 for s, e in rec.spans("folds"))
