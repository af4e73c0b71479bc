"""``pls_solve_ms``: device time of the operations whose name holds
``ikpls2`` (the PLS solve, whatever route implements it: ``ikpls2`` on
formed fold matrices, or the ``ikpls2_wide_op`` kernels with none formed)
among those launched in the folds' span, summed a total, mean over the
traced totals; ``None`` where no such operation ran. Read as ``pls_ms``
reads it, in the cells that list it."""

from .pls_ms import read  # noqa: F401

LAYER = "models.pls"
UNIT = "ms"
BETTER = "lower"
MOVES = "folds_per_s"
SOURCE = "device_trace"
