"""cvmatrix_tpu_torch — the PyTorch/CUDA port of the fast cross-validation engine.

A port of :mod:`cvmatrix_tpu` (the JAX reference package in this
repository) to PyTorch, with hand-written CUDA kernels for the NVIDIA H100
(``sm_90a``) where the JAX package has Pallas kernels. It computes in native
float64, or in float32 for a float32 config (every float32 product in full
float32), and imports neither JAX nor ``cvmatrix_tpu``. Importing it builds
and loads no kernel: each kernel is compiled from ``csrc/`` at first launch.

Public surface: ``CVMatrix`` (the engine facade) and ``Partitioner`` (fold
bookkeeping), ``cross_validate_pls`` (PLS cross-validation, the port's
own), plus the functional core (``CVConfig``, ``FitState``, ``fit``,
``training_*``) and the routing policy (``RoutingPolicy``, ``policy``,
``set_routing``). Entry points given non-tensor inputs run on the CUDA
card unless the caller passes ``device="cpu"``.
"""

from .config import CVConfig
from .core import (
    FitState,
    fit,
    training_matrices,
    training_statistics,
    training_XTX,
    training_XTX_XTY,
    training_XTY,
)
from .models import CVMatrix, Partitioner, cross_validate_pls
from .policy import RoutingPolicy, policy, set_routing

__version__ = "0.1.0"

__all__ = [
    "CVMatrix",
    "Partitioner",
    "cross_validate_pls",
    "CVConfig",
    "FitState",
    "fit",
    "training_matrices",
    "training_XTX",
    "training_XTY",
    "training_XTX_XTY",
    "training_statistics",
    "RoutingPolicy",
    "policy",
    "set_routing",
    "__version__",
]
