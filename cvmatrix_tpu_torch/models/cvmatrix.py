"""Reference-compatible object facade over the functional core (PyTorch port).

Counterpart of :class:`cvmatrix_tpu.models.cvmatrix.CVMatrix`: the same
constructor knobs and the same four public per-fold methods, returning
``(matrices, (X_mean, X_std, Y_mean, Y_std))`` as tensors. Differences:

- ``backend`` must be ``"torch"``.
- ``device`` selects where the fitted state lives (default: the device of
  a tensor ``X``, else the CUDA card; without a card pass ``"cpu"``).
- ``copy`` is honoured: with ``copy=True`` the fitted state never shares
  memory with the caller's arrays; with ``copy=False`` it may.
"""

from __future__ import annotations

from typing import Literal, Optional, Tuple

import numpy as np

from ..config import CVConfig
from ..core import fold as _fold
from ..core.fit import fit as _fit_fn
from ..core.state import FitState

__all__ = ["CVMatrix"]


class CVMatrix:
    """Fast cross-validation training-matrix engine (Engstrøm–Jensen).

    Computes the dataset-wide ``X^T W X`` / ``X^T W Y`` once at ``fit`` time,
    then derives every fold's *training-set* matrices by downdating the
    validation block and applying weighted centring/scaling corrections as
    rank-one updates — per-fold cost independent of training-set size.
    """

    def __init__(
        self,
        center_X: bool = True,
        center_Y: bool = True,
        scale_X: bool = True,
        scale_Y: bool = True,
        ddof: int = 1,
        dtype=np.float64,
        copy: bool = True,
        backend: Literal["torch"] = "torch",
        matmul_mode: str = "auto",
        device=None,
    ) -> None:
        if backend != "torch":
            raise ValueError(
                f"Invalid backend: {backend!r}. This engine is the PyTorch "
                "port; only backend='torch' is supported (it runs on CPU and "
                "CUDA)."
            )
        self.config = CVConfig(
            center_X=center_X,
            center_Y=center_Y,
            scale_X=scale_X,
            scale_Y=scale_Y,
            ddof=ddof,
            dtype=dtype,
            matmul_mode=matmul_mode,
        )
        self.copy = copy
        self.backend = backend
        self.device = device
        self.state: Optional[FitState] = None

    # ---- constructor-knob passthroughs (reference attribute parity) ----

    @property
    def center_X(self) -> bool:
        return self.config.center_X

    @property
    def center_Y(self) -> bool:
        return self.config.center_Y

    @property
    def scale_X(self) -> bool:
        return self.config.scale_X

    @property
    def scale_Y(self) -> bool:
        return self.config.scale_Y

    @property
    def ddof(self) -> int:
        return self.config.ddof

    @property
    def dtype(self):
        return self.config.dtype

    @property
    def resolution(self) -> float:
        return self.config.resolution

    # ---- fitted-state passthroughs -------------------------------------

    def __getattr__(self, name):
        # Only reached for attributes not found normally: the FitState
        # fields (X, WX, XTX, sum_w, ...) read through, None before fit.
        if name in FitState.__dataclass_fields__:
            state = self.__dict__.get("state")
            return None if state is None else getattr(state, name)
        raise AttributeError(name)

    @property
    def N(self) -> Optional[int]:
        return None if self.state is None else self.state.N

    @property
    def K(self) -> Optional[int]:
        return None if self.state is None else self.state.K

    @property
    def M(self) -> Optional[int]:
        return None if self.state is None else self.state.M

    # ---- public API ------------------------------------------------------

    def fit(self, X, Y=None, weights=None) -> "CVMatrix":
        """Load data and compute dataset-wide products/statistics.

        Raises ``ValueError`` for negative weights. Returns ``self``.
        """
        self.state = _fit_fn(self.config, X, Y, weights, copy=self.copy,
                             device=self.device)
        return self

    def _require_fit(self) -> FitState:
        if self.state is None:
            raise ValueError("fit() must be called before per-fold methods.")
        return self.state

    def training_XTX(self, validation_indices, mask=None):
        """Training ``X^T W X`` for one fold."""
        return _fold.training_XTX(
            self.config, self._require_fit(), validation_indices, mask
        )

    def training_XTY(self, validation_indices, mask=None):
        """Training ``X^T W Y`` for one fold."""
        return _fold.training_XTY(
            self.config, self._require_fit(), validation_indices, mask
        )

    def training_XTX_XTY(self, validation_indices, mask=None):
        """Training ``X^T W X`` and ``X^T W Y`` for one fold."""
        return _fold.training_XTX_XTY(
            self.config, self._require_fit(), validation_indices, mask
        )

    def training_statistics(self, validation_indices, mask=None) -> Tuple:
        """Training means/stds only."""
        return _fold.training_statistics(
            self.config, self._require_fit(), validation_indices, mask
        )

    def cross_validate_reduce(self, partitioner, *, reduce_fn, **kw):
        """Every fold of ``partitioner`` through ``reduce_fn(matrices,
        stats)`` on the fitted state's device; only the reductions are kept.

        Returns ``(fold_keys, stacked_reductions)`` over
        ``partitioner.padded_batches()``; see
        :func:`cvmatrix_tpu_torch.models.sweep.cross_validate_reduce`.
        """
        from .sweep import cross_validate_reduce as _cvr

        state = self._require_fit()
        keys, idx, mask = partitioner.padded_batches()
        return keys, _cvr(self.config, state, idx, mask, reduce_fn=reduce_fn,
                          **kw)

    def _training_matrices(self, return_XTX, return_XTY, validation_indices,
                           mask=None):
        """Reference-private-API parity shim."""
        return _fold.training_matrices(
            self.config,
            self._require_fit(),
            validation_indices,
            mask,
            return_XTX=return_XTX,
            return_XTY=return_XTY,
        )
