"""``fit_ms``: host time of ``core.fit.fit`` a total, from the start of its
span to the ``synchronize()`` that ends it, mean over the traced totals."""

from ..tracing import mean

LAYER = "core.fit"
UNIT = "ms"
BETTER = "lower"
MOVES = "folds_per_s"
SOURCE = "program_span"


def read(rec):
    return mean((e - s) / 1e3 for s, e in rec.spans("fit"))
