"""The immutable fitted state of the cross-validation engine (PyTorch port).

Counterpart of :mod:`cvmatrix_tpu.core.state`: a frozen dataclass of tensors
with the same fields. Absent statistics are ``None``. As in the JAX package,
the weighted squared matrices are not materialised; the per-fold code
recomputes squared rows from the gathered ``WX[v]`` and ``X[v]`` rows.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

__all__ = ["FitState"]


@dataclasses.dataclass(frozen=True)
class FitState:
    """Fitted dataset-wide tensors and statistics.

    Shapes: ``X (N, K)``, ``Y (N, M)``, ``weights (N, 1)``,
    ``XTX (K, K)``, ``XTY (K, M)``, row-stat vectors ``(1, K)`` / ``(1, M)``,
    scalars 0-d.
    """

    X: torch.Tensor
    WX: torch.Tensor
    Y: Optional[torch.Tensor]
    WY: Optional[torch.Tensor]
    weights: Optional[torch.Tensor]

    XTX: torch.Tensor
    XTY: Optional[torch.Tensor]

    sum_X: Optional[torch.Tensor]
    sum_Y: Optional[torch.Tensor]
    sum_sq_X: Optional[torch.Tensor]
    sum_sq_Y: Optional[torch.Tensor]
    sum_w: Optional[torch.Tensor]
    num_nonzero_w: Optional[torch.Tensor]

    @property
    def N(self) -> int:
        return self.X.shape[0]

    @property
    def K(self) -> int:
        return self.X.shape[1]

    @property
    def M(self) -> Optional[int]:
        return None if self.Y is None else self.Y.shape[1]

    @property
    def device(self) -> torch.device:
        return self.X.device

    @classmethod
    def from_numpy(cls, fields: Mapping[str, Optional[np.ndarray]],
                   device="cpu") -> "FitState":
        """Build a state from per-field arrays (``None`` stays ``None``).

        ``fields`` maps every field name to an array-like, for example
        ``{f: np.asarray(getattr(jax_state, f)) for f in names}`` taken from
        the JAX package's ``FitState``. Every array is copied onto
        ``device`` with its own dtype, so the same fitted state can feed
        both packages.
        """
        names = [f.name for f in dataclasses.fields(cls)]
        missing = set(names) - set(fields)
        if missing:
            raise ValueError(f"missing FitState fields: {sorted(missing)}")
        return cls(**{
            n: None if fields[n] is None
            else torch.tensor(np.asarray(fields[n]), device=device)
            for n in names
        })
