"""The numbers ``correct`` compares: widest gaps against the reference."""

from __future__ import annotations

import math
from typing import Optional

import torch


def gap(out: Optional[torch.Tensor], ref: Optional[torch.Tensor]) -> float:
    """The widest gap of ``out`` from ``ref`` over the largest magnitude of
    ``ref``; 0 where neither exists, infinite where only one does or where
    ``out`` holds a NaN."""
    if out is None and ref is None:
        return 0.0
    if out is None or ref is None or out.shape != ref.shape:
        return math.inf
    out = out.to(device=ref.device, dtype=torch.float64)
    g = float((out - ref).abs().max())
    if math.isnan(g):
        return math.inf
    return g / max(float(ref.abs().max()), 1e-300)
