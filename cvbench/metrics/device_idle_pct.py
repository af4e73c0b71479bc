"""``device_idle_pct``: the share of the traced totals' wall time (each from
its start to its end) in which no device operation runs."""

LAYER = "device (H100)"
UNIT = "%"
BETTER = "lower"
MOVES = "folds_per_s"
SOURCE = "device_trace"


def read(rec):
    if not rec.ops:
        return None
    return 100 * (1 - rec.busy_total() / rec.wall_total())
