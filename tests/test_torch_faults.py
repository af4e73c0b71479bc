"""Fold indices and masks at the port's batched entries (CPU cases; the card
cases are in ``tests/test_torch_cuda.py``).

- Negative fold indices: ``training_matrices_batched``, ``materialize_sweep``
  and ``cross_validate_reduce`` take [-N, N) and wrap the negative ones, as
  NumPy indexing, the port's per-fold engine and the JAX package's XLA
  engine do; anything outside raises. The operand builders and the kernels'
  row check stay at [0, N).
- Masks given as tensors: a CPU ``torch`` mask gives the NumPy mask's result
  through ``training_matrices_batched``, ``materialize_sweep`` and
  ``materialize_cv``.
- The LOOCV sources keep the rows they checked (``LoocvSources.rows``), a
  copy of the caller's, and ``smallfold_from_sources`` on slices of them
  gives the result of the same rows handed in afresh.
"""

import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import cvmatrix_tpu as J
import cvmatrix_tpu_torch as T
from cvmatrix_tpu.core import batch as JB
from cvmatrix_tpu.models import sweep as JS
from cvmatrix_tpu_torch.core import batch as TB
from cvmatrix_tpu_torch.models import sweep as TS

from .data import make_dataset, zero_fraction

X_ALL, Y_ALL, _, WEIGHTS = make_dataset(n=200, k=6, m=2)
N = X_ALL.shape[0]
W_ALL = zero_fraction(WEIGHTS)
# fold rows -> the port's route (K=6, M=2, float64, exact mode)
ROUTES = {1: "loocv", 4: "packed", 10: "v3"}


def _fit(flags, weighted, mode="auto"):
    jcfg = J.CVConfig(*flags, matmul_mode=mode)
    js = J.fit(jcfg, X_ALL, Y_ALL, W_ALL if weighted else None)
    st = T.FitState.from_numpy({
        f.name: None if getattr(js, f.name) is None
        else np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)})
    return jcfg, js, T.CVConfig(*flags, matmul_mode=mode), st


def _folds(n_l):
    """Twenty folds of ``n_l`` distinct rows, and the same folds with every
    other column given as its negative index (row - N)."""
    idx = (np.arange(20 * n_l) * 7 % N).reshape(20, n_l)
    neg = idx.copy()
    neg[:, ::2] -= N
    return idx, neg


def _mats(mats):
    return np.concatenate([np.asarray(m) for m in mats], axis=2)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("n_l", sorted(ROUTES))
def test_negative_folds_match_jax_and_fold_engine(n_l, weighted):
    """[-N, 0) through training_matrices_batched: the JAX XLA engine on the
    same negative folds at 1e-8, the port on the wrapped folds bit for bit,
    and the per-fold engine on one negative fold at 1e-10."""
    flags = (True, True, True, True)
    jcfg, js, cfg, st = _fit(flags, weighted)
    idx, neg = _folds(n_l)
    assert (neg < 0).any() and neg.min() >= -N
    assert TB.route_kernel(cfg, st, n_l, True, True, False) == ROUTES[n_l]
    mats, stats = TB.training_matrices_batched(cfg, st, neg)
    jmats, jstats = JB.training_matrices_batched(jcfg, js, neg, impl="xla")
    assert_allclose(_mats(mats), _mats(jmats), atol=1e-8, rtol=0)
    for a, b in zip(stats, jstats):
        assert (a is None) == (b is None)
        if a is not None:
            assert_allclose(a.numpy(), np.asarray(b), atol=1e-8, rtol=0)
    wrapped, _ = TB.training_matrices_batched(cfg, st, idx)
    assert all(torch.equal(a, b) for a, b in zip(mats, wrapped))
    (xtx, xty), _ = T.training_matrices(cfg, st, neg[3])
    assert_allclose(mats[0][3].numpy(), xtx.numpy(), atol=1e-10, rtol=0)
    assert_allclose(mats[1][3].numpy(), xty.numpy(), atol=1e-10, rtol=0)


@pytest.mark.parametrize("n_l", sorted(ROUTES))
def test_negative_folds_through_the_sweeps(n_l):
    """[-N, 0) through materialize_sweep (against the JAX XLA sweep on the
    same folds at 1e-8 and the port on the wrapped folds exactly) and
    cross_validate_reduce (the wrapped folds' reductions exactly)."""
    jcfg, js, cfg, st = _fit((True, False, True, True), True)
    idx, neg = _folds(n_l)
    got = TS.materialize_sweep(cfg, st, neg, batch_size=3)
    ref = JS.materialize_sweep(jcfg, js, neg, batch_size=3, impl="xla")
    assert_allclose(float(got), float(ref), atol=1e-8, rtol=0)
    assert float(got) == float(TS.materialize_sweep(cfg, st, idx,
                                                    batch_size=3))

    def red(mats, stats):
        return torch.trace(mats[0]) + mats[1].sum()

    got = TS.cross_validate_reduce(cfg, st, neg, reduce_fn=red, batch_size=8)
    ref = TS.cross_validate_reduce(cfg, st, idx, reduce_fn=red, batch_size=8)
    assert torch.equal(got, ref)


def test_folds_outside_minus_n_to_n_raise():
    """-N - 1 and N raise ValueError from the three batched entries; the
    operand builders keep [0, N) and raise on -1."""
    _, _, cfg, st = _fit((True,) * 4, True)
    for bad in (np.array([[-N - 1, 2]]), np.array([[0, N]])):
        with pytest.raises(ValueError, match=rf"outside \[-{N}, {N}\)"):
            TB.training_matrices_batched(cfg, st, bad)
        with pytest.raises(ValueError, match=rf"outside \[-{N}, {N}\)"):
            TS.materialize_sweep(cfg, st, bad)
        with pytest.raises(ValueError, match=rf"outside \[-{N}, {N}\)"):
            TS.cross_validate_reduce(cfg, st, bad,
                                     reduce_fn=lambda m, s: m[0].sum())
    for builder in (TB.prepare_fold_operands, TB.prepare_ozaki_sources):
        with pytest.raises(ValueError, match=rf"outside \[0, {N}\)"):
            builder(cfg, st, np.array([[-1, 2]]))
    with pytest.raises(TypeError, match="integers"):
        TB.training_matrices_batched(cfg, st, np.array([[0.0, 1.0]]))


@pytest.mark.parametrize("n_l,mode,route", [(5, "auto", "packed"),
                                            (10, "auto", "v3"),
                                            (40, "native", "epilogue")])
def test_torch_mask_matches_numpy_mask(n_l, mode, route):
    """A CPU torch mask (float64 and bool) gives the NumPy mask's result
    through training_matrices_batched, materialize_sweep and
    materialize_cv, on the masked packed, v3 and bmm + epilogue routes."""
    _, _, cfg, st = _fit((True, True, True, True), True, mode)
    assert TB.route_kernel(cfg, st, n_l, True, True, True) == route
    idx = (np.arange(5 * n_l) * 3 % N).reshape(5, n_l)
    mask = np.ones(idx.shape)
    mask[::2, -2:] = 0.0
    ref, ref_stats = TB.training_matrices_batched(cfg, st, idx, mask)
    ref_probe = TS.materialize_sweep(cfg, st, idx, mask, batch_size=2)
    ref_cv = TS.materialize_cv(cfg, X_ALL, Y_ALL, W_ALL, idx, mask,
                               batch_size=2, device="cpu")
    for tmask in (torch.from_numpy(mask), torch.from_numpy(mask > 0)):
        got, got_stats = TB.training_matrices_batched(cfg, st, idx, tmask)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        assert all(torch.equal(a, b) for a, b in zip(got_stats, ref_stats))
        assert torch.equal(TS.materialize_sweep(cfg, st, idx, tmask,
                                                batch_size=2), ref_probe)
        assert torch.equal(TS.materialize_cv(
            cfg, X_ALL, Y_ALL, W_ALL, idx, tmask, batch_size=2,
            device="cpu"), ref_cv)


@pytest.mark.parametrize("masked", [False, True])
def test_sources_keep_their_checked_rows(masked):
    """prepare_loocv_sources keeps (F, L) int64 copies of the rows it
    checked; smallfold_from_sources over slices of them, chunk by chunk,
    equals the call on the caller's own rows."""
    _, _, cfg, st = _fit((True, True, True, True), True)
    idx, _ = _folds(4)
    mask = None
    if masked:
        mask = np.ones(idx.shape)
        mask[::3, -1] = 0.0
    caller = torch.from_numpy(idx.copy())
    src = TB.prepare_loocv_sources(cfg, st, caller, mask)
    assert src.rows.shape == idx.shape and src.rows.dtype == torch.int64
    assert torch.equal(src.rows, caller)
    caller[0, 0] = N  # the sources hold a copy
    assert int(src.rows[0, 0]) == idx[0, 0]
    kw = dict(n_l=4, return_XTY=True, has_mask=masked)
    ref = TB.smallfold_from_sources(cfg, src, idx, **kw)
    for sl in (slice(0, 7), slice(7, 20)):
        got = TB.smallfold_from_sources(
            cfg, src, src.rows[sl], src.scal[sl],
            None if mask is None else src.mask[sl], **kw)
        assert torch.equal(got, ref[sl])
