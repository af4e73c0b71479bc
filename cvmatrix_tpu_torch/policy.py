"""Kernel-routing policy of the PyTorch port: every auto-routing knob in one
place.

Counterpart of :mod:`cvmatrix_tpu.policy`, with the same fields, defaults
and ``CVMATRIX_TPU_*`` environment overrides (read once at import), so that
one ``set_routing`` call in each package sends a fold batch to the same
kernel in both. The port keeps its own copy: it imports nothing of the JAX
package. The JAX package clears its compiled programs on ``set_routing``;
the port runs eagerly and reads the policy at every call, so it has no
cache to clear and no ``register_cache``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace

__all__ = ["RoutingPolicy", "policy", "set_routing"]


@dataclass(frozen=True)
class RoutingPolicy:
    """Auto-routing decisions for the fold-sweep engine.

    sym_loocv
        Float64 only: the symmetric LOOCV kernel (``fused_loocv_df64_sym``'s
        port) and the symmetric v3 kernel (``fused_ozaki_downdate_v3_sym``'s
        port) compute the upper triangle of each fold's X block and mirror
        the rest. Applies where :func:`~cvmatrix_tpu_torch.core.batch.
        loocv_sym_tile` of the JAX package's padded width is not ``None``.
    f32x2 / df64x2
        Two folds per block in the float32 / float64 LOOCV kernel (the ports
        of ``fused_loocv_f32x2`` and ``fused_loocv_df64x2``); the
        materialising sweeps bump their chunks to an even fold count.
        ``sym_loocv`` wins over ``df64x2``.
    batch_syrk
        Accepted and ignored. In the JAX package it picks a SYRK contraction
        for the wide-K product of its large-fold path; the port forms that
        product with one ``torch.bmm``, so there is nothing to choose.
    ozaki_budget_log2
        Trim budget (log2) of the JAX package's Ozaki slice-product groups.
        The port has no int8 slices, but the budget sets the group count
        that the v3 gate and the reduce sweep's hoist estimate read, so it
        is kept to route as the JAX package does.
    hoist_reduce
        Build the reduce sweeps' operands once for all folds (the packed and
        v3 routes' hoisted body); off, every chunk runs the generic body.
    """

    sym_loocv: bool = False
    f32x2: bool = False
    df64x2: bool = False
    batch_syrk: bool = False
    ozaki_budget_log2: int = -31
    hoist_reduce: bool = True


def _env_policy() -> RoutingPolicy:
    base = RoutingPolicy()

    def flag(name: str, default: bool) -> bool:
        v = os.environ.get(name)
        return default if v is None else v != "0"

    return RoutingPolicy(
        sym_loocv=flag("CVMATRIX_TPU_SYM_LOOCV", base.sym_loocv),
        f32x2=flag("CVMATRIX_TPU_F32X2", base.f32x2),
        df64x2=flag("CVMATRIX_TPU_DF64X2", base.df64x2),
        batch_syrk=flag("CVMATRIX_TPU_BATCH_SYRK", base.batch_syrk),
        ozaki_budget_log2=int(os.environ.get(
            "CVMATRIX_TPU_OZAKI_BUDGET_LOG2", base.ozaki_budget_log2)),
        hoist_reduce=flag("CVMATRIX_TPU_HOIST_REDUCE", base.hoist_reduce),
    )


_ACTIVE = _env_policy()


def policy() -> RoutingPolicy:
    """The active routing policy (read at every routing decision)."""
    return _ACTIVE


def set_routing(**updates) -> RoutingPolicy:
    """Replace routing fields and return the new active policy.

    Unknown field names raise ``TypeError`` (``dataclasses.replace``)::

        set_routing(sym_loocv=True)   # the next sweep routes sym
    """
    global _ACTIVE
    _ACTIVE = replace(_ACTIVE, **updates)
    return _ACTIVE
