"""Static configuration for the fast cross-validation engine (PyTorch port).

Counterpart of :mod:`cvmatrix_tpu.config`: the same frozen, hashable
dataclass with the reference's knobs (``center_X/center_Y/scale_X/scale_Y,
ddof, dtype``) and the same derived facts. ``matmul_mode`` is kept for
signature parity only: the port computes float64 natively, so every mode is
one float64 GEMM.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["CVConfig"]


@dataclasses.dataclass(frozen=True)
class CVConfig:
    """Immutable preprocessing/precision configuration.

    >>> cfg = CVConfig(center_X=True, center_Y=False, scale_X=False,
    ...                scale_Y=False, ddof=0, dtype=np.float32)
    >>> cfg.torch_dtype
    torch.float32
    >>> CVConfig(dtype=np.int32)
    Traceback (most recent call last):
        ...
    ValueError: dtype must be a floating dtype, got dtype('int32').
    """

    center_X: bool = True
    center_Y: bool = True
    scale_X: bool = True
    scale_Y: bool = True
    ddof: int = 1
    dtype: Any = np.float64
    # "auto" | "exact" | "native": accepted for parity, all one f64 GEMM.
    matmul_mode: str = "auto"

    def __post_init__(self) -> None:
        dt = np.dtype(self.dtype)
        if dt.kind != "f":
            raise ValueError(f"dtype must be a floating dtype, got {dt!r}.")
        object.__setattr__(self, "dtype", dt.type)
        if self.matmul_mode not in ("auto", "exact", "native"):
            raise ValueError(
                f"Invalid matmul_mode: {self.matmul_mode!r}. "
                "Must be 'auto', 'exact', or 'native'."
            )

    @property
    def torch_dtype(self) -> torch.dtype:
        """The torch dtype of ``dtype`` (np.float64 -> torch.float64)."""
        return torch.from_numpy(np.empty(0, self.dtype)).dtype

    @property
    def resolution(self) -> float:
        """Std clamp threshold: stds <= resolution are replaced by 1.

        Matches ``np.finfo(dtype).resolution * 10`` (the reference's rule).
        """
        return float(np.finfo(self.dtype).resolution * 10)

    @property
    def any_stats(self) -> bool:
        """Whether fit must compute sum_w / num_nonzero_w."""
        return self.center_X or self.center_Y or self.scale_X or self.scale_Y

    @property
    def needs_sum_X(self) -> bool:
        return self.center_X or self.center_Y or self.scale_X

    @property
    def needs_sum_Y(self) -> bool:
        """Additionally requires Y to be present."""
        return self.center_X or self.center_Y or self.scale_Y

    @property
    def needs_WY(self) -> bool:
        """Weighted case only."""
        return self.center_X or self.center_Y or self.scale_Y
