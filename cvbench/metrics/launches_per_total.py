"""``launches_per_total``: device operations of any name (kernels, copies,
fills) that start inside a traced total, per total."""

LAYER = "device (H100)"
UNIT = "count"
BETTER = "lower"
MOVES = "folds_per_s"
SOURCE = "device_trace"


def read(rec):
    if not rec.ops:
        return None
    spans = rec.spans("total")
    return sum(len(rec.ops_in(sp)) for sp in spans) / len(spans)
