"""The port's per-fold engine against ``cvmatrix_tpu`` and the NumPy oracle.

Same NumPy inputs through both packages' ``CVMatrix`` over the flag lattice
x weights, for the four public per-fold methods, at the 1e-8 contract; the
matrices also against ``tests/oracle.py``. Then the batched ``(F, L)`` form,
masks, and the eager error paths of ``tests/test_api.py``.
"""

from itertools import product

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import cvmatrix_tpu as J
import cvmatrix_tpu_torch as T

from .data import make_dataset, train_indices, zero_fraction
from .oracle import NaiveOracle

X_ALL, Y_ALL, FOLDS, WEIGHTS = make_dataset(n=60, k=5, m=2)
P = J.Partitioner(FOLDS)


def _np(a):
    return None if a is None else np.asarray(a)


def assert_tree_close(got, ref, atol=1e-8):
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_tree_close(g, r, atol)
        return
    assert (got is None) == (ref is None)
    if ref is not None:
        assert tuple(got.shape) == np.asarray(ref).shape
        assert_allclose(_np(got), _np(ref), atol=atol, rtol=0)


@pytest.mark.parametrize("ddof", [0, 1])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("flags", list(product([False, True], repeat=4)))
def test_fold_methods_match_jax_and_oracle(flags, weighted, ddof):
    w = zero_fraction(WEIGHTS) if weighted else None
    tm = T.CVMatrix(*flags, ddof=ddof, device="cpu").fit(X_ALL, Y_ALL, w)
    jm = J.CVMatrix(*flags, ddof=ddof).fit(X_ALL, Y_ALL, w)
    oracle = NaiveOracle(*flags, ddof=ddof).fit(X_ALL, Y_ALL, w)
    for fold, vi in P.folds_dict.items():
        for name in ("training_XTX", "training_XTY", "training_XTX_XTY",
                     "training_statistics"):
            assert_tree_close(getattr(tm, name)(vi), getattr(jm, name)(vi))
        (xtx, xty), _ = tm.training_XTX_XTY(vi)
        (oxtx, oxty), _ = oracle.training_XTX_XTY(
            train_indices(P.folds_dict, fold))
        assert_allclose(xtx.numpy(), oxtx, atol=1e-8, rtol=0)
        assert_allclose(xty.numpy(), oxty, atol=1e-8, rtol=0)


@pytest.mark.parametrize("weighted", [True, False])
def test_batched_indices_match_per_fold(weighted):
    """An (F, L) index batch gives the stacked per-fold results (the
    counterpart of the JAX package's vmap)."""
    w = WEIGHTS if weighted else None
    cfg = T.CVConfig(True, False, True, True)
    st = T.fit(cfg, X_ALL, Y_ALL, w, device="cpu")
    idx = np.arange(60).reshape(12, 5)
    (bx, by), bstats = T.training_XTX_XTY(cfg, st, idx)
    for f in range(12):
        (x, y), stats = T.training_XTX_XTY(cfg, st, idx[f])
        assert_allclose(bx[f].numpy(), x.numpy(), atol=1e-12)
        assert_allclose(by[f].numpy(), y.numpy(), atol=1e-12)
        for a, b in zip(bstats, stats):
            assert (a is None) == (b is None)
            if a is not None:
                assert_allclose(a[f].numpy(), b.numpy(), atol=1e-12)


@pytest.mark.parametrize("weighted", [True, False])
def test_masked_batch_matches_jax(weighted):
    import jax

    w = WEIGHTS if weighted else None
    flags = (True, True, True, False)
    keys, idx, mask = P.padded_batches()
    assert mask is not None
    tst = T.fit(T.CVConfig(*flags), X_ALL, Y_ALL, w, device="cpu")
    jcfg = J.CVConfig(*flags)
    jst = J.fit(jcfg, X_ALL, Y_ALL, w)
    got = T.training_XTX_XTY(T.CVConfig(*flags), tst, idx, mask)
    ref = jax.vmap(lambda v, m: J.training_XTX_XTY(jcfg, jst, v, m))(idx, mask)
    assert_tree_close(got, ref)


def test_float32_mask_keeps_config_dtype():
    cvm = T.CVMatrix(True, True, True, True, 1, dtype=np.float32,
                      device="cpu").fit(
        X_ALL[:40].astype(np.float32), Y_ALL[:40].astype(np.float32), None)
    p = T.Partitioner(np.array([0] * 15 + [1] * 25))
    _, idx, mask = p.padded_batches()
    (xtx, xty), _ = cvm.training_XTX_XTY(idx[0], mask[0])
    assert xtx.dtype == torch.float32 and xty.dtype == torch.float32


def test_negative_weights_raise():
    with pytest.raises(ValueError, match="Weights must be non-negative."):
        T.CVMatrix(device="cpu").fit(X_ALL, Y_ALL, -WEIGHTS)


def test_missing_y_and_flag_errors():
    cvm = T.CVMatrix(device="cpu").fit(X_ALL[:, :4], None, WEIGHTS)
    vi = P.get_validation_indices(0)
    for call in (cvm.training_XTX_XTY, cvm.training_XTY):
        with pytest.raises(ValueError,
                           match="Response variables `Y` are not provided."):
            call(vi)
    with pytest.raises(ValueError,
                       match="At least one of `return_XTX` and `return_XTY`"):
        cvm._training_matrices(False, False, vi)


def test_unfit_model_and_backend_raise():
    with pytest.raises(ValueError, match="fit\\(\\) must be called"):
        T.CVMatrix().training_XTX(np.arange(3))
    assert T.CVMatrix().XTX is None
    with pytest.raises(ValueError, match="Invalid backend"):
        T.CVMatrix(backend="jax")


def test_degenerate_ddof_fold_raises():
    """ddof >= training nnz raises eagerly, as in tests/test_api.py."""
    w = WEIGHTS.copy()
    w[2:] = 0.0
    folds = np.zeros(60, dtype=int)
    folds[:2] = 1
    vi = T.Partitioner(folds).get_validation_indices(0)
    msg = "must be greater than `ddof`"
    cvm = T.CVMatrix(True, True, True, True, ddof=2,
                     device="cpu").fit(X_ALL, Y_ALL, w)
    for call in (cvm.training_XTX_XTY, cvm.training_XTX, cvm.training_XTY):
        with pytest.raises(ValueError, match=msg):
            call(vi)
    cvm2 = T.CVMatrix(False, True, False, True, ddof=2,
                      device="cpu").fit(X_ALL, Y_ALL, w)
    cvm2.training_XTX(vi)  # no X-side stats: no raise
    with pytest.raises(ValueError, match=msg):
        cvm2.training_XTY(vi)


def test_all_training_weights_zero_raises():
    w = WEIGHTS.copy()
    w[FOLDS != 0] = 0.0
    vi = P.get_validation_indices(0)
    msg = "must be greater than zero"
    for cx, cy, sx, sy in product([False, True], repeat=4):
        if not (cx or cy or sx or sy):
            continue
        cvm = T.CVMatrix(cx, cy, sx, sy, ddof=0, device="cpu").fit(
            X_ALL, Y_ALL, w)
        with pytest.raises(ValueError, match=msg):
            cvm.training_XTX_XTY(vi)
        if cx or sx:
            with pytest.raises(ValueError, match=msg):
                cvm.training_XTX(vi)
        else:
            cvm.training_XTX(vi)
    T.CVMatrix(False, False, False, False, ddof=0, device="cpu").fit(
        X_ALL, Y_ALL, w).training_XTX_XTY(vi)


def test_out_of_range_indices_raise():
    """NumPy's eager rule: [-N, N) is valid; beyond it raises (a CUDA
    gather would fault instead)."""
    cvm = T.CVMatrix(device="cpu").fit(X_ALL, Y_ALL, WEIGHTS)
    ref = J.CVMatrix().fit(X_ALL, Y_ALL, WEIGHTS)
    assert_tree_close(cvm.training_XTX(np.array([-1, 3])),
                      ref.training_XTX(np.array([59, 3])))
    for bad in ([0, 60], [-61, 1]):
        with pytest.raises(IndexError, match="out of range"):
            cvm.training_XTX_XTY(np.array(bad))
