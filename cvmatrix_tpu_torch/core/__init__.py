from .state import FitState
from .fit import fit
from .fold import (
    training_matrices,
    training_XTX,
    training_XTY,
    training_XTX_XTY,
    training_statistics,
)

__all__ = [
    "FitState",
    "fit",
    "training_matrices",
    "training_XTX",
    "training_XTY",
    "training_XTX_XTY",
    "training_statistics",
]
