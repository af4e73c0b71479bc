"""``pls_solve_roofline_pct``: the least time of one total's PLS work
(``pls_costs``: A (2 K^2 + 6 K M) FLOPs a fold at 67 TFLOP/s, or the fitted
total, the validation rows and the PRESS moved once at 3.35 TB/s; the folds'
training matrices are not counted, so no design reads over 100%) over
``pls_solve_ms``. The entry ``pls`` records the least time of the run's
cell (``cvbench.entries.pls.LEAST_PLS_S``); ``None`` where no ``ikpls2``
operation ran or no such entry ran."""

import sys

from . import pls_solve_ms

LAYER = "models.pls"
UNIT = "%"
BETTER = "higher"
MOVES = "folds_per_s"
SOURCE = "device_trace"


def read(rec):
    ms = pls_solve_ms.read(rec)
    least = getattr(sys.modules.get("cvbench.entries.pls"), "LEAST_PLS_S",
                    None)
    if not ms or least is None:
        return None
    return 100 * least * 1e3 / ms
