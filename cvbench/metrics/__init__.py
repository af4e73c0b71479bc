"""The per-layer metrics, one reader each, found by the metric's name."""
