"""The port's fit against ``cvmatrix_tpu.fit``, field by field.

Same NumPy inputs (from a seed) through both packages; every ``FitState``
field must agree at the repository's 1e-8 contract (in practice they agree
to rounding). Also the state converter and the ``copy`` knob.
"""

import dataclasses
from itertools import product

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import cvmatrix_tpu as J
import cvmatrix_tpu_torch as T

from .data import make_dataset, zero_fraction

X_ALL, Y_ALL, FOLDS, WEIGHTS = make_dataset(n=80, k=6, m=3)
FIELDS = [f.name for f in dataclasses.fields(J.FitState)]


def numpy_fields(state):
    return {f: None if getattr(state, f) is None
            else np.asarray(getattr(state, f)) for f in FIELDS}


def assert_states_match(ts, js, atol=1e-8):
    for f in FIELDS:
        a, b = getattr(ts, f), getattr(js, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, f
        assert_allclose(a.numpy(), b, atol=atol, rtol=0, err_msg=f)


@pytest.mark.parametrize("with_y", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("flags", list(product([False, True], repeat=4)))
def test_fit_matches_jax(flags, weighted, with_y):
    w = zero_fraction(WEIGHTS) if weighted else None
    Y = Y_ALL if with_y else None
    ts = T.fit(T.CVConfig(*flags), X_ALL, Y, w, device="cpu")
    js = J.fit(J.CVConfig(*flags), X_ALL, Y, w)
    assert_states_match(ts, js)
    assert ts.XTX.dtype == torch.float64
    if ts.num_nonzero_w is not None:
        assert int(ts.num_nonzero_w) == int(js.num_nonzero_w)


def test_fit_promotes_1d_inputs():
    cfg = (True, True, True, True)
    x, y, w = X_ALL[:, 0], Y_ALL[:, 0], WEIGHTS
    ts = T.fit(T.CVConfig(*cfg), x, y, w, device="cpu")
    js = J.fit(J.CVConfig(*cfg), x, y, w)
    assert tuple(ts.X.shape) == (80, 1) and tuple(ts.Y.shape) == (80, 1)
    assert tuple(ts.weights.shape) == (80, 1)
    assert_states_match(ts, js)


@pytest.mark.parametrize("weighted", [True, False])
def test_from_numpy_round_trips_jax_state(weighted):
    js = J.fit(J.CVConfig(), X_ALL, Y_ALL, WEIGHTS if weighted else None)
    fields = numpy_fields(js)
    ts = T.FitState.from_numpy(fields)
    for f in FIELDS:
        a = getattr(ts, f)
        if fields[f] is None:
            assert a is None
            continue
        assert a.numpy().dtype == fields[f].dtype, f
        assert_array_equal(a.numpy(), fields[f], err_msg=f)
    assert (ts.N, ts.K, ts.M) == (js.N, js.K, js.M)
    with pytest.raises(ValueError, match="missing FitState fields"):
        T.FitState.from_numpy({"X": fields["X"]})


def test_copy_isolates_caller_buffers():
    X = X_ALL.copy()
    w = WEIGHTS.copy()
    cfg = T.CVConfig()
    copied = T.fit(cfg, X, Y_ALL, w, copy=True, device="cpu")
    shared = T.fit(cfg, X, Y_ALL, w, copy=False, device="cpu")
    X[0, 0] = 1e6
    w[0] = 1e6
    assert float(copied.X[0, 0]) == X_ALL[0, 0]
    assert float(copied.weights[0, 0]) == WEIGHTS[0]
    assert float(shared.X[0, 0]) == 1e6  # copy=False may share memory
    Xt = torch.from_numpy(X_ALL.copy())
    st = T.fit(cfg, Xt, None, None, copy=True)
    Xt[1, 1] = -5.0
    assert float(st.X[1, 1]) == X_ALL[1, 1]


def test_fit_rejects_negative_weights():
    with pytest.raises(ValueError, match="Weights must be non-negative."):
        T.fit(T.CVConfig(), X_ALL, Y_ALL, -WEIGHTS, device="cpu")
    T.fit(T.CVConfig(), X_ALL, Y_ALL, -WEIGHTS, validate=False,
          device="cpu")  # skipped


def test_fit_float32_keeps_dtype():
    cfg = T.CVConfig(dtype=np.float32)
    ts = T.fit(cfg, X_ALL, Y_ALL, WEIGHTS, device="cpu")
    js = J.fit(J.CVConfig(dtype=np.float32), X_ALL, Y_ALL, WEIGHTS)
    for f in FIELDS:
        a = getattr(ts, f)
        if a is not None and a.is_floating_point():
            assert a.dtype == torch.float32, f
            # f32 sums over 80 rows in another order: ~1e-6 relative.
            assert_allclose(a.numpy(), np.asarray(getattr(js, f)),
                            rtol=1e-5, atol=1e-3, err_msg=f)


def test_default_device_needs_a_card(monkeypatch):
    """With NumPy inputs and no ``device``, the entry points run on the CUDA
    card; without one (here forced) they raise, naming ``device="cpu"``,
    and tensor inputs stay where they are."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from cvmatrix_tpu_torch.models import sweep as TS

    idx = np.arange(X_ALL.shape[0])[:, None]
    for call in (lambda: T.fit(T.CVConfig(), X_ALL, Y_ALL),
                 lambda: T.CVMatrix().fit(X_ALL, Y_ALL),
                 lambda: TS.materialize_cv(T.CVConfig(), X_ALL, Y_ALL,
                                           None, idx)):
        with pytest.raises(ValueError, match="device='cpu'"):
            call()
    st = T.fit(T.CVConfig(), torch.from_numpy(X_ALL), None)
    assert st.device == torch.device("cpu")
