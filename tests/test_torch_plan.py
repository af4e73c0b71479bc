"""The port's three fold entries against each other on the CPU.

For every route of ``core.batch.route_kernel`` (the cases of
``test_torch_spans.ROUTE_CASES``), ``materialize_sweep``'s buffer,
``training_matrices_batched`` and ``cross_validate_reduce`` with an
identity-copy reduction build the same route's fold plan for the same
folds, in two chunks where the entry chunks, and return the same matrices
within 1e-12 of the largest entry.
"""

import dataclasses

import pytest
import torch

import cvmatrix_tpu_torch as T
from cvmatrix_tpu_torch.core import batch as TB
from cvmatrix_tpu_torch.models import sweep as TS

from .test_torch_spans import ROUTE_CASES, _folds, _state


@pytest.fixture
def policy_restored():
    before = T.policy()
    yield
    T.set_routing(**dataclasses.asdict(before))


@pytest.mark.parametrize("route", list(ROUTE_CASES))
def test_entries_return_the_same_matrices(route, monkeypatch,
                                          policy_restored):
    k, m, dtype, mode, n_folds, n_l, n, knobs = ROUTE_CASES[route]
    cfg, st = _state(k, m, dtype, mode, n)
    idx, _ = _folds(n_folds, n_l, n)
    T.set_routing(**knobs)
    built, buffers = [], []

    def spy(config, state, r, *a, _fn=TB._plan, **kw):
        plan = _fn(config, state, r, *a, **kw)
        if plan is None:
            return None
        built.append(r)

        def run(c0, size, out=None):
            res = plan.run(c0, size, out)
            if out is not None:  # the materialising sweep's buffer
                buffers.append(out.clone())
            return res
        return plan._replace(run=run)

    monkeypatch.setattr(TB, "_plan", spy)
    bs = n_folds // 2
    TS.materialize_sweep(cfg, st, idx, batch_size=bs)
    swept = torch.cat(buffers)[:n_folds]
    mats, _ = TB.training_matrices_batched(cfg, st, idx)
    batched = torch.cat(mats, dim=-1)
    reduced = torch.cat(TS.cross_validate_reduce(
        cfg, st, idx, reduce_fn=lambda mats, stats: mats, batch_size=bs),
        dim=-1)
    assert set(built) == {route} and len(buffers) == 2
    scale = batched.abs().max()
    for got in (swept, reduced):
        assert got.shape == batched.shape and got.dtype == batched.dtype
        assert (got - batched).abs().max() <= 1e-12 * scale
