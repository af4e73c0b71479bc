"""PLS cross-validation on the port (``cvmatrix_tpu_torch.models.pls``) against
the plain reference ``tests/pls_reference.py``, and the reference against
NIPALS.

Tolerances, and why:

- reference against NIPALS, equal ``B`` to 1e-10 of its largest entry: two
  float64 algorithms on the same preprocessed rows, NIPALS iterated until
  its scores move by under 1e-15; both differ from the exact answer by
  rounding amplified by the components' conditioning, which this data
  keeps small.
- the port against the reference, PRESS to 1e-9 of the fold's largest
  PRESS (``PRESS_TOL``): the port's fold matrices come from the fitted
  totals by the engine's downdate and the reference's from the training
  rows, two float64 orders of the same sums (about 1e-14 apart at these
  sizes, ``tests/test_torch_loocv.py``), which the A components amplify
  by their conditioning; the Jacobi eigenvector and ``eigh``'s agree to
  rounding. The same reference computed in float32 misses it by over
  three decades (``test_float32_misses_the_tolerance``).

- the operator route's twin against the twin on formed fold matrices,
  PRESS to 1e-11 of the fold's largest (``OP_TOL``): both start from the
  same fitted totals and differ in the order of their sums (the product
  with the total against the formed matrix, ``S q`` against ``XTY^T r``)
  and in Jacobi's start (warm against cold), about 1e-13 apart at these
  sizes; the operator kernel against its twin, 1e-12 on the card, where
  the tensor cores' sums take another order again.

Leave-one-out batches of a float64 state take the operator route and
buckets with K over ``ops.pls.MAX_K`` the wide operator route
(``models.pls.operator_route`` names both); K-fold, masked, float32 and
``impl="torch"`` batches the formed matrices. The CPU runs the twins
(``ops.pls.ikpls2_operator_reference``, ``ops.pls.ikpls2_reference``); the
cases marked ``cuda`` run the kernels and skip without a card. This file
imports no JAX; on a card, ``python -m pytest --noconftest -q
tests/test_torch_pls.py``.
"""

import itertools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cvmatrix_tpu_torch as T
from cvmatrix_tpu_torch.core import batch as TB
from cvmatrix_tpu_torch.models import pls as TP
from cvmatrix_tpu_torch.models import sweep as TS
from cvmatrix_tpu_torch.ops import pls as OP
from cvmatrix_tpu_torch.utils import profiling as P

from .pls_reference import (
    fold_press,
    ikpls2_coefficients,
    nipals_coefficients,
    training_products,
)

ROOT = Path(__file__).resolve().parents[1]
PRESS_TOL = 1e-9
OP_TOL = 1e-11
N, K, A = 30, 5, 3
FLAGS = list(itertools.product([True, False], repeat=4))


def _data(m, n=N, k=K, seed=0):
    """X uniform; Y a linear map of X with well separated response scales
    plus noise, so that every component's eigen-gap is wide."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, k))
    beta = rng.normal(size=(k, m)) * (3.0 ** -np.arange(m))
    Y = X @ beta + 0.05 * rng.normal(size=(n, m))
    w = rng.uniform(0.2, 1.5, size=n)
    w[::7] = 0.0
    return X, Y, w


def _folds(scheme, n=N):
    """``(idx, mask, validation rows of each fold)``: LOOCV; K-fold of 3
    folds of 10 rows (the v3 body); 10 folds of 3 rows (the small-fold
    body); 7 uneven folds as one padded masked batch."""
    if scheme == "loocv":
        idx, mask = np.arange(n)[:, None], None
    elif scheme in ("kfold", "small"):
        p = 3 if scheme == "kfold" else 10
        idx, mask = np.arange(n).reshape(-1, p).T.copy(), None
    else:
        p = 7
        L = -(-n // p)
        idx = np.arange(p)[:, None] + p * np.arange(L)[None, :]
        mask = (idx < n).astype(np.float64)
        idx = np.where(idx < n, idx, np.arange(p)[:, None])
    val = [row if mask is None else row[mask[f] == 1]
           for f, row in enumerate(idx)]
    return idx, mask, val


def _reference(X, Y, w, val, flags, ddof, n_components=A,
               dtype=torch.float64):
    c_x, c_y, s_x, s_y = flags
    return torch.stack([
        fold_press(torch.as_tensor(X), torch.as_tensor(Y),
                   None if w is None else torch.as_tensor(w), v,
                   n_components=n_components, center_X=c_x, center_Y=c_y,
                   scale_X=s_x, scale_Y=s_y, ddof=ddof, dtype=dtype)
        for v in val])


def _gap(got, ref):
    """The widest gap of each fold's PRESS over that fold's largest
    reference PRESS, worst fold."""
    got = torch.as_tensor(got).to(torch.float64).cpu()
    ref = ref.cpu()
    scale = ref.abs().amax(dim=(1, 2)).clamp_min(1e-300)
    return float(((got - ref).abs().amax(dim=(1, 2)) / scale).max())


def _run(dev, flags, weighted, m, scheme, ddof, impl="auto", dtype=None):
    X, Y, w = _data(m)
    if not weighted:
        w = None
    cfg = T.CVConfig(*flags, ddof=ddof,
                     **({} if dtype is None else {"dtype": dtype}))
    st = T.fit(cfg, X, Y, w, device=dev)
    idx, mask, val = _folds(scheme)
    got = T.cross_validate_pls(cfg, st, idx, mask, n_components=A,
                               batch_size=4, impl=impl)
    return got, _reference(X, Y, w, val, flags, ddof)


# ---- the reference against an independent algorithm --------------------- #

@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("m", [1, 3])
def test_reference_matches_nipals(m, weighted):
    X, Y, w = _data(m, n=60, k=6, seed=3)
    X, Y = torch.as_tensor(X), torch.as_tensor(Y)
    w = torch.as_tensor(w) if weighted else None
    keep = torch.ones(60, dtype=torch.bool)
    keep[::5] = False
    XTX, XTY, _, Xp, Yp, wt = training_products(
        X, Y, w, keep, center_X=True, center_Y=True, scale_X=True,
        scale_Y=True, ddof=1, resolution=1e-14)
    root = torch.ones(1) if wt is None else wt.sqrt()
    B_nip, iters = nipals_coefficients(Xp * root, Yp * root, 5)
    B = ikpls2_coefficients(XTX, XTY, 5)
    assert iters < 100_000
    for a in range(5):
        assert float((B[a] - B_nip[a]).abs().max()) <= (
            1e-10 * float(B_nip[a].abs().max())), a


# ---- the port against the reference, on the CPU (the twin) --------------- #

@pytest.mark.parametrize("ddof", [0, 1])
@pytest.mark.parametrize("scheme", ["loocv", "kfold", "masked"])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("flags", FLAGS)
def test_twin_matches_reference(flags, weighted, m, scheme, ddof):
    got, ref = _run("cpu", flags, weighted, m, scheme, ddof)
    assert got.shape == ref.shape == (len(ref), A, m)
    assert got.dtype == torch.float64
    assert _gap(got, ref) <= PRESS_TOL


# ---- the operator route: no fold matrix formed ------------------------- #

def _operator_and_formed(flags, weighted, m, ddof, n_components=A, data=None,
                         dev="cpu"):
    """Every leave-one-out fold of ``_data`` through the operator twin and
    through the twin on formed fold matrices, and the reference."""
    X, Y, w = _data(m) if data is None else data
    if not weighted:
        w = None
    cfg = T.CVConfig(*flags, ddof=ddof)
    st = T.fit(cfg, X, Y, w, device=dev)
    idx, _, val = _folds("loocv", n=X.shape[0])
    op = T.cross_validate_pls(cfg, st, idx, n_components=n_components,
                              batch_size=8)
    formed = TS.cross_validate_reduce(
        cfg, st, idx, chunk_fn=lambda mats, stats, rows: TP.solve(
            cfg, mats, stats, rows, n_components=n_components,
            impl="torch"), batch_size=8, impl="torch")[:len(val)]
    return op, formed, _reference(X, Y, w, val, flags, ddof,
                                  n_components=n_components)


@pytest.mark.parametrize("ddof", [0, 1])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("flags", FLAGS)
def test_operator_twin_matches_formed_twin(flags, weighted, m, ddof):
    """The operator route's twin against the twin on formed matrices and
    the reference, every flag set; the folds of weight 0 read 0."""
    op, formed, ref = _operator_and_formed(flags, weighted, m, ddof)
    assert op.shape == formed.shape == ref.shape == (N, A, m)
    assert _gap(op, formed) <= OP_TOL
    assert _gap(op, ref) <= PRESS_TOL
    if weighted:
        assert torch.equal(op[::7], torch.zeros_like(op[::7]))


@pytest.mark.parametrize("m", [1, 3])
def test_operator_twin_every_component(m):
    """A = K components, the most the training rows allow here."""
    op, formed, ref = _operator_and_formed((True,) * 4, True, m, 1,
                                           n_components=K)
    assert op.shape == (N, K, m)
    assert _gap(op, formed) <= OP_TOL
    assert _gap(op, ref) <= PRESS_TOL


def test_operator_twin_wider_and_longer():
    """K = 12, M = 4, A = 8 on 40 rows: more components than responses."""
    rng = np.random.default_rng(7)
    X = rng.uniform(size=(40, 12))
    Y = X @ rng.normal(size=(12, 4)) + 0.1 * rng.normal(size=(40, 4))
    w = rng.uniform(0.2, 1.5, size=40)
    op, formed, ref = _operator_and_formed((True,) * 4, True, 4, 1,
                                           n_components=8, data=(X, Y, w))
    assert _gap(op, formed) <= OP_TOL
    assert _gap(op, ref) <= PRESS_TOL


@pytest.mark.parametrize("route", ["operator", "formed"])
def test_degenerate_component_reads_nan(route):
    """Y of zeros and no centring: XTY is 0, so the first component is
    degenerate and every component reads NaN, on both routes."""
    X, _, w = _data(1)
    cfg = T.CVConfig(False, False, False, False)
    st = T.fit(cfg, X, np.zeros((N, 1)), w, device="cpu")
    idx = np.arange(N)[:, None]
    got = T.cross_validate_pls(cfg, st, idx, n_components=3,
                               impl="auto" if route == "operator" else "torch")
    assert got.shape == (N, 3, 1) and bool(torch.isnan(got).all())


@pytest.mark.parametrize("case, operator", [
    ("loocv", True), ("loocv_torch", False), ("loocv_float32", False),
    ("loocv_masked", False), ("kfold", False), ("small", False),
    ("masked", False), ("loocv_wide", False)])
def test_route_gate(monkeypatch, case, operator):
    """Leave-one-out float64 takes the operator route under "auto"; a
    mask, more rows a fold, float32, ``impl="torch"`` or K over
    ``ops.pls.MAX_OP_K`` take the formed matrices."""
    ran = []
    real_op, real_sweep = TP._operator_sweep, TP.cross_validate_reduce
    monkeypatch.setattr(TP, "_operator_sweep", lambda *a, **k: ran.append(
        "operator") or real_op(*a, **k))
    monkeypatch.setattr(TP, "cross_validate_reduce", lambda *a, **k: ran.append(
        "formed") or real_sweep(*a, **k))
    if case == "loocv_wide":
        monkeypatch.setattr(OP, "MAX_OP_K", K - 1)
    dtype = np.float32 if case == "loocv_float32" else np.float64
    cfg, st = _state(dtype=dtype)
    scheme = case if case in ("kfold", "small", "masked") else "loocv"
    idx, mask, _ = _folds(scheme)
    if case == "loocv_masked":
        mask = np.ones(idx.shape)
    impl = "torch" if case == "loocv_torch" else "auto"
    T.cross_validate_pls(cfg, st, idx, mask, n_components=2, impl=impl)
    assert ran == ["operator" if operator else "formed"]
    assert TP.operator_route(cfg, st, idx, mask, impl) == (
        "operator" if operator else None)


def test_fold_components_by_route():
    cfg, st = _state()
    OP.reset_launch_counts()
    T.cross_validate_pls(cfg, st, np.arange(N)[:, None], n_components=2)
    idx, _, _ = _folds("kfold")
    T.cross_validate_pls(cfg, st, idx, n_components=2, batch_size=3)
    assert OP.fold_components("operator") == N * 2
    assert OP.fold_components("matrices") == 3 * 2
    assert OP.fold_components() == N * 2 + 3 * 2
    with pytest.raises(ValueError, match="Unknown route"):
        OP.fold_components("both")


def test_warm_jacobi_matches_cold():
    """Jacobi started from an orthogonal basis finds the same dominant
    eigenvector, up to sign, and returns the eigenvectors it found: from
    those, no sweep is needed."""
    rng = np.random.default_rng(9)
    for m in (2, 5, 10):
        G = torch.as_tensor(rng.normal(size=(6, 30, m)))
        S = G.mT @ G
        basis = torch.linalg.qr(torch.as_tensor(rng.normal(size=(6, m, m))))[0]
        cold = OP.jacobi_dominant(S)
        warm, V = OP.jacobi_dominant(S, basis=basis)
        sign = torch.sign((warm * cold).sum(1, keepdim=True))
        assert float((warm * sign - cold).abs().max()) <= 1e-12, m
        again, V2 = OP.jacobi_dominant(S, max_sweeps=0, basis=V)
        assert torch.equal(again, warm) and torch.equal(V2, V)


def test_operator_wrapper_checks():
    cfg, st = _state()
    sums = (st.sum_X, st.sum_sq_X, st.sum_Y, st.sum_sq_Y, st.sum_w,
            st.num_nonzero_w)
    kw = dict(center_X=True, center_Y=True, scale_X=True, scale_Y=True,
              ddof=1, resolution=cfg.resolution)
    rows = torch.arange(4)
    with pytest.raises(ValueError, match="n_components"):
        OP.ikpls2_operator(st.XTX, st.XTY, st.X, st.Y, st.weights, sums,
                           rows, n_components=0, **kw)
    with pytest.raises(ValueError, match="impl='cuda'"):
        OP.ikpls2_operator(st.XTX, st.XTY, st.X, st.Y, st.weights, sums,
                           rows, n_components=2, impl="cuda", **kw)
    got = OP.ikpls2_operator(st.XTX, st.XTY, st.X, st.Y, st.weights, sums,
                             rows, n_components=2, **kw)
    ref = OP.ikpls2_operator_reference(st.XTX, st.XTY, st.X, st.Y,
                                       st.weights, sums, rows,
                                       n_components=2, **kw)
    assert torch.equal(got, ref)


def _run_formed(dev, scheme, impl, m=3):
    """The formed-matrix route as ``cross_validate_pls`` runs it for the
    buckets it does not send to the operator: the reduce sweep with
    :func:`models.pls.solve` as its chunk consumer."""
    X, Y, w = _data(m)
    cfg = T.CVConfig(ddof=1)
    st = T.fit(cfg, X, Y, w, device=dev)
    idx, mask, val = _folds(scheme)
    got = TS.cross_validate_reduce(
        cfg, st, idx, mask, chunk_fn=lambda mats, stats, rows: TP.solve(
            cfg, mats, stats, rows, n_components=A, impl=impl),
        batch_size=4, impl=impl)[:len(val)]
    return got, _reference(X, Y, w, val, (True,) * 4, 1)


@pytest.mark.parametrize("body, scheme, impl", [
    ("loocv", "loocv", "auto"),
    ("v3", "kfold", "auto"),
    ("packed", "small", "auto"),
    ("packed", "masked", "auto"),
    (None, "loocv", "torch"),
    (None, "masked", "torch"),
])
def test_every_sweep_body(monkeypatch, body, scheme, impl):
    """Each of the sweep's bodies hands the PLS consumer its chunks (the
    formed-matrix route): ``body`` is the route of the hoisted body's one
    fold plan; ``None`` is the generic per-chunk body, a plan a chunk."""
    built = []

    def spy(config, state, route, *a, _fn=TB._plan, **kw):
        plan = _fn(config, state, route, *a, **kw)
        if plan is not None:
            built.append(route)
        return plan
    monkeypatch.setattr(TB, "_plan", spy)
    got, ref = _run_formed("cpu", scheme, impl)
    if body is None:
        n_folds = _folds(scheme)[0].shape[0]
        assert len(built) == -(-n_folds // 4) and len(set(built)) == 1
    else:
        assert built == [body]
    assert _gap(got, ref) <= PRESS_TOL


def test_float32_misses_the_tolerance():
    """The reference in float32, and the port on a float32 state (the
    twin), each miss the tolerance by over three decades."""
    X, Y, w = _data(3)
    _, _, val = _folds("loocv")
    flags = (True,) * 4
    ref = _reference(X, Y, w, val, flags, 1)
    low = _reference(X, Y, w, val, flags, 1, dtype=torch.float32)
    assert _gap(low, ref) > 1e3 * PRESS_TOL
    got32, _ = _run("cpu", flags, True, 3, "loocv", 1, dtype=np.float32)
    assert got32.dtype == torch.float32
    assert _gap(got32, ref) > 1e3 * PRESS_TOL


def test_jacobi_matches_eigh():
    """The Jacobi eigenvector of the largest eigenvalue against ``eigh``'s,
    up to sign, on random symmetric positive semi-definite matrices of 1 to
    12 rows, odd and even."""
    rng = np.random.default_rng(5)
    for m in range(1, 13):
        G = torch.as_tensor(rng.normal(size=(9, 20, m)))
        S = G.mT @ G
        v = OP.jacobi_dominant(S)
        ref = torch.linalg.eigh(S)[1][:, :, -1]
        sign = torch.sign((v * ref).sum(1, keepdim=True))
        assert float((v * sign - ref).abs().max()) <= 1e-12, m


def test_round_robin_covers_every_pair_once():
    for m in range(1, 34):
        rounds = OP.round_robin_pairs(m)
        pairs = [p for r in rounds for p in r]
        assert sorted(pairs) == [(p, q) for p in range(m)
                                 for q in range(p + 1, m)]
        for r in rounds:
            idx = [i for p in r for i in p]
            assert len(idx) == len(set(idx))


# ---- the wide route: formed fold matrices wider than MAX_K ---------------- #

WN, WK, WA, WP = 40, 120, 4, 5


def _wide_run(dev, flags, ddof, m, masked=False, n_components=WA,
              impl="auto"):
    """``cross_validate_pls`` at N = 40, K = 120 (> N), A = 4: 5 folds of 8
    rows, or 7 uneven folds as one masked bucket; weights with zeros."""
    X, Y, w = _data(m, n=WN, k=WK, seed=4)
    cfg = T.CVConfig(*flags, ddof=ddof)
    st = T.fit(cfg, X, Y, w, device=dev)
    if masked:
        idx, mask, val = _folds("masked", n=WN)
    else:
        idx = np.arange(WN).reshape(-1, WP).T.copy()
        mask, val = None, list(idx)
    got = T.cross_validate_pls(cfg, st, idx, mask, n_components=n_components,
                               batch_size=2, impl=impl)
    return got, _reference(X, Y, w, val, flags, ddof,
                           n_components=n_components)


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("ddof", [0, 1])
@pytest.mark.parametrize("flags", FLAGS)
def test_wide_route_matches_reference(monkeypatch, flags, ddof, m):
    """With ``MAX_K`` below K the K-fold buckets take the wide route with
    no fold matrix formed (its twin on the CPU), every flag set, ddof 0
    and 1, weights with zeros; 3 chunks of 2, 2 and 1 folds."""
    monkeypatch.setattr(OP, "MAX_K", WK - 1)
    OP.reset_launch_counts()
    got, ref = _wide_run("cpu", flags, ddof, m)
    assert got.shape == ref.shape == (WP, WA, m)
    assert OP.fold_components("wide_op") == WP * WA
    assert OP.fold_components("wide") == OP.fold_components("matrices") == 0
    assert _gap(got, ref) <= PRESS_TOL


@pytest.mark.parametrize("m", [1, 3])
def test_wide_route_masked_bucket(monkeypatch, m):
    monkeypatch.setattr(OP, "MAX_K", WK - 1)
    OP.reset_launch_counts()
    got, ref = _wide_run("cpu", (True,) * 4, 1, m, masked=True)
    assert got.shape == ref.shape == (7, WA, m)
    assert OP.fold_components("wide_op") == 7 * WA  # 4 chunks, no padding
    assert OP.fold_components("wide") == 0
    assert _gap(got, ref) <= PRESS_TOL


@pytest.mark.parametrize("case, wide", [
    ("over", "wide_op"), ("at", None), ("torch", "wide"),
    ("float32", "wide"), ("masked", "wide_op")])
def test_wide_route_gate(monkeypatch, case, wide):
    """The route follows K: K over ``MAX_K`` takes the wide route, with no
    fold matrix formed for float64 under "auto" (K-fold and masked alike)
    and on formed matrices under ``impl="torch"`` and for float32 (the
    twins here), and K at the limit takes ``ikpls2``; a leave-one-out
    bucket takes the operator where it did (float64, "auto"), else the
    wide route on formed matrices."""
    monkeypatch.setattr(OP, "MAX_K", WK if case == "at" else WK - 1)
    dtype = np.float32 if case == "float32" else np.float64
    X, Y, w = _data(2, n=WN, k=WK)
    cfg = T.CVConfig(dtype=dtype)
    st = T.fit(cfg, X, Y, w, device="cpu")
    impl = "torch" if case == "torch" else "auto"
    if case == "masked":
        idx, mask, _ = _folds("masked", n=WN)
    else:
        idx, mask = np.arange(WN).reshape(-1, WP).T.copy(), None
    OP.reset_launch_counts()
    T.cross_validate_pls(cfg, st, idx, mask, n_components=2, impl=impl)
    for route in ("wide", "wide_op"):
        assert OP.fold_components(route) == (
            len(idx) * 2 if wide == route else 0), route
    assert OP.fold_components("matrices") == (0 if wide else len(idx) * 2)
    OP.reset_launch_counts()
    T.cross_validate_pls(cfg, st, np.arange(WN)[:, None], n_components=2,
                         impl=impl)
    operator = impl == "auto" and dtype == np.float64
    assert OP.fold_components("operator") == (WN * 2 if operator else 0)
    assert OP.fold_components("wide") == (0 if operator else WN * 2)
    assert OP.fold_components("wide_op") == 0


def test_wide_wrapper_dispatch(monkeypatch):
    """On the CPU ``ikpls2_wide`` runs the twin, bit for bit, counts its
    fold-components under "wide" and launches nothing; "cuda" raises.
    ``ikpls2`` sends K over ``MAX_K`` to it, counted under "wide" alone."""
    X, Y, w = _data(2, n=WN, k=WK)
    cfg = T.CVConfig()
    st = T.fit(cfg, X, Y, w, device="cpu")
    idx = np.arange(WN).reshape(-1, WP).T.copy()
    (mats, stats), = [TB.training_matrices_batched(cfg, st, idx)]
    rows = TB._copied_rows(cfg, st, idx, None)(0, WP)
    kw = dict(n_components=3, center_X=True, center_Y=True, scale_X=True,
              scale_Y=True)
    OP.reset_launch_counts()
    got = OP.ikpls2_wide(*mats, rows.X, rows.Y, rows.w, rows.mask, stats,
                         **kw)
    ref = OP.ikpls2_reference(*mats, rows.X, rows.Y, rows.w, rows.mask,
                              stats, **kw)
    assert torch.equal(got, ref)
    assert OP.fold_components("wide") == WP * 3
    assert OP.launch_counts() == {"ikpls2": 0, "ikpls2_op": 0,
                                  "ikpls2_wide": 0, "ikpls2_wide_op": 0}
    with pytest.raises(ValueError, match="impl='cuda'"):
        OP.ikpls2_wide(*mats, rows.X, rows.Y, rows.w, rows.mask, stats,
                       impl="cuda", **kw)
    with pytest.raises(ValueError, match="n_components"):
        OP.ikpls2_wide(*mats, rows.X, rows.Y, rows.w, rows.mask, stats,
                       **{**kw, "n_components": 0})
    monkeypatch.setattr(OP, "MAX_K", WK - 1)
    OP.reset_launch_counts()
    sent = OP.ikpls2(*mats, rows.X, rows.Y, rows.w, rows.mask, stats, **kw)
    assert torch.equal(sent, ref)
    assert OP.fold_components("wide") == WP * 3
    assert OP.fold_components("matrices") == 0


# ---- the wide operator route: no fold matrix formed above MAX_K ----------- #

def _wide_op_case(flags, weighted, m, scheme, ddof, n_components=WA,
                  dev="cpu"):
    """``_data`` at N = 40, K = 120 (> N), A = 4, the bucket ``scheme``
    (5 K-fold folds of 8 rows, 7 uneven masked folds, or leave-one-out),
    through ``cross_validate_pls`` under "auto" with ``MAX_K`` (and, for
    leave-one-out, ``MAX_OP_K``) below K, which the caller lowers; and the
    formed route's twin (``impl="torch"``: ``ikpls2_reference`` on the same
    folds' formed matrices) and the reference."""
    X, Y, w = _data(m, n=WN, k=WK, seed=4)
    if not weighted:
        w = None
    cfg = T.CVConfig(*flags, ddof=ddof)
    st = T.fit(cfg, X, Y, w, device=dev)
    if scheme == "masked":
        idx, mask, val = _folds("masked", n=WN)
    elif scheme == "loocv":
        idx, mask, val = _folds("loocv", n=WN)
    else:
        idx = np.arange(WN).reshape(-1, WP).T.copy()
        mask, val = None, list(idx)
    got = T.cross_validate_pls(cfg, st, idx, mask, n_components=n_components,
                               batch_size=3)
    formed = T.cross_validate_pls(cfg, st, idx, mask,
                                  n_components=n_components, batch_size=3,
                                  impl="torch")
    return got, formed, _reference(X, Y, w, val, flags, ddof,
                                   n_components=n_components)


@pytest.mark.parametrize("ddof", [0, 1])
@pytest.mark.parametrize("scheme", ["kfold", "masked", "loocv"])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("flags", FLAGS)
def test_wide_op_twin_matches_formed_twin(monkeypatch, flags, weighted, m,
                                          scheme, ddof):
    """The wide operator route's twin against ``ikpls2_reference`` on the
    same folds' formed matrices (``OP_TOL``) and against the reference
    (``PRESS_TOL``), every flag set, weights with zeros or none, K-fold,
    masked and leave-one-out; the folds of weight 0 read 0."""
    monkeypatch.setattr(OP, "MAX_K", WK - 1)
    monkeypatch.setattr(OP, "MAX_OP_K", WK - 1)
    OP.reset_launch_counts()
    got, formed, ref = _wide_op_case(flags, weighted, m, scheme, ddof)
    assert got.shape == formed.shape == ref.shape == (len(ref), WA, m)
    assert got.dtype == torch.float64
    assert OP.fold_components("wide_op") == len(ref) * WA
    assert _gap(got, formed) <= OP_TOL
    assert _gap(got, ref) <= PRESS_TOL
    if weighted and scheme == "loocv":
        assert torch.equal(got[::7], torch.zeros_like(got[::7]))


@pytest.mark.parametrize("case, route", [
    ("kfold", "wide_op"), ("masked", "wide_op"), ("loocv", "wide_op"),
    ("kfold_at", "wide_op"), ("masked_at", "wide_op"),
    ("kfold_below", "matrices"), ("masked_below", "matrices"),
    ("kfold_torch", "wide"), ("masked_torch", "wide"),
    ("loocv_operator", "operator"), ("loocv_torch", "wide")])
def test_wide_op_route_gate_and_counters(monkeypatch, case, route):
    """K-fold, masked and leave-one-out buckets over ``MAX_K`` count their
    F x A under "wide_op" and none under "wide"; K-fold and masked buckets
    at ``MAX_K`` with ``MAX_OP_K`` below K do too; K at most ``MAX_OP_K``
    keeps ``ikpls2``, ``impl="torch"`` the formed wide route, and
    leave-one-out at K up to ``MAX_OP_K`` the operator route, untouched."""
    scheme, _, variant = case.partition("_")
    monkeypatch.setattr(OP, "MAX_K",
                        WK if variant in ("at", "below") else WK - 1)
    if variant not in ("operator", "below"):
        monkeypatch.setattr(OP, "MAX_OP_K", WK - 1)
    X, Y, w = _data(2, n=WN, k=WK)
    cfg = T.CVConfig()
    st = T.fit(cfg, X, Y, w, device="cpu")
    if scheme == "kfold":
        idx, mask = np.arange(WN).reshape(-1, WP).T.copy(), None
    else:
        idx, mask, _ = _folds(scheme, n=WN)
    impl = "torch" if variant == "torch" else "auto"
    ran = []
    for name in ("_operator_sweep", "cross_validate_reduce"):
        real = getattr(TP, name)
        monkeypatch.setattr(TP, name, lambda *a, _n=name, _r=real, **k: (
            ran.append(_n), _r(*a, **k))[1])
    OP.reset_launch_counts()
    T.cross_validate_pls(cfg, st, idx, mask, n_components=2, impl=impl)
    for r in ("operator", "matrices", "wide", "wide_op"):
        assert OP.fold_components(r) == (len(idx) * 2 if r == route else 0), r
    no_matrix = route in ("wide_op", "operator")
    assert ran == ["_operator_sweep" if no_matrix else "cross_validate_reduce"]
    assert TP.operator_route(cfg, st, idx, mask, impl) == (
        route if no_matrix else None)
    assert OP.launch_counts() == {"ikpls2": 0, "ikpls2_op": 0,
                                  "ikpls2_wide": 0, "ikpls2_wide_op": 0}


@pytest.mark.parametrize("case, route", [
    ("kfold", "wide_op"), ("masked", "wide_op"), ("loocv", "formed"),
    ("kfold_torch", "formed"), ("masked_torch", "formed"),
    ("kfold_float32", "formed"), ("masked_float32", "formed")])
def test_band_route_gate(monkeypatch, case, route):
    """With ``MAX_OP_K`` < K <= ``MAX_K`` (the band where most spectra
    lie), float64 K-fold and masked buckets under "auto" take the wide
    operator route; leave-one-out there, ``impl="torch"`` and float32 form
    their fold matrices for ``ikpls2`` (its twin here), as K at most
    ``MAX_OP_K`` does (``test_wide_op_route_gate_and_counters``)."""
    scheme, _, variant = case.partition("_")
    monkeypatch.setattr(OP, "MAX_K", K + 1)
    monkeypatch.setattr(OP, "MAX_OP_K", K - 1)
    cfg, st = _state(dtype=np.float32 if variant == "float32"
                     else np.float64)
    idx, mask, _ = _folds(scheme)
    impl = "torch" if variant == "torch" else "auto"
    ran = []
    for name in ("_operator_sweep", "cross_validate_reduce"):
        real = getattr(TP, name)
        monkeypatch.setattr(TP, name, lambda *a, _n=name, _r=real, **k: (
            ran.append(_n), _r(*a, **k))[1])
    OP.reset_launch_counts()
    got = T.cross_validate_pls(cfg, st, idx, mask, n_components=2,
                               impl=impl)
    assert got.shape == (len(idx), 2, 2)
    assert TP.operator_route(cfg, st, idx, mask, impl) == (
        "wide_op" if route == "wide_op" else None)
    assert ran == ["_operator_sweep" if route == "wide_op"
                   else "cross_validate_reduce"]
    counted = "matrices" if route == "formed" else "wide_op"
    for r in ("operator", "matrices", "wide", "wide_op"):
        assert OP.fold_components(r) == (len(idx) * 2 if r == counted
                                         else 0), r


BAND_FLAGS = [(True,) * 4, (False,) * 4, (True, True, False, False),
              (True, False, True, False)]


@pytest.mark.parametrize("scheme", ["kfold", "masked"])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("flags", BAND_FLAGS)
def test_wide_op_twin_m12_in_the_band(monkeypatch, flags, weighted, scheme):
    """M = 12 responses (a soil library's laboratory properties) with K
    between ``MAX_OP_K`` and ``MAX_K``: K-fold and masked buckets take the
    wide operator route (its twin here), within ``OP_TOL`` of the formed
    route's twin and ``PRESS_TOL`` of the reference, F x A fold-components
    on that route."""
    monkeypatch.setattr(OP, "MAX_OP_K", WK - 1)
    OP.reset_launch_counts()
    got, formed, ref = _wide_op_case(flags, weighted, 12, scheme, 1)
    assert got.shape == formed.shape == ref.shape == (len(ref), WA, 12)
    assert OP.fold_components("wide_op") == len(ref) * WA
    assert _gap(got, formed) <= OP_TOL
    assert _gap(got, ref) <= PRESS_TOL


def test_wide_op_wrapper_dispatch():
    """On the CPU ``ikpls2_wide_op`` runs the twin, bit for bit, into
    ``out`` where given, counts its fold-components under "wide_op" and
    launches nothing; "cuda" raises, and so does a bad ``n_components``."""
    X, Y, w = _data(2, n=WN, k=WK)
    cfg = T.CVConfig()
    st = T.fit(cfg, X, Y, w, device="cpu")
    sums = (st.sum_X, st.sum_sq_X, st.sum_Y, st.sum_sq_Y, st.sum_w,
            st.num_nonzero_w)
    rows = torch.as_tensor(np.arange(WN).reshape(-1, WP).T.copy())
    kw = dict(n_components=3, center_X=True, center_Y=True, scale_X=True,
              scale_Y=True, ddof=1, resolution=cfg.resolution)
    args = (st.XTX, st.XTY, st.X, st.Y, st.weights, sums, rows, None)
    OP.reset_launch_counts()
    got = OP.ikpls2_wide_op(*args, **kw)
    ref = OP.ikpls2_wide_op_reference(*args, **kw)
    assert torch.equal(got, ref)
    out = torch.empty((WP, 3, 2), dtype=torch.float64)
    assert OP.ikpls2_wide_op(*args, out=out, **kw) is out
    assert torch.equal(out, ref)
    assert OP.fold_components("wide_op") == 2 * WP * 3
    assert OP.launch_counts()["ikpls2_wide_op"] == 0
    with pytest.raises(ValueError, match="impl='cuda'"):
        OP.ikpls2_wide_op(*args, impl="cuda", **kw)
    with pytest.raises(ValueError, match="n_components"):
        OP.ikpls2_wide_op(*args, **{**kw, "n_components": 0})


# ---- inputs -------------------------------------------------------------- #

def _state(m=2, dtype=np.float64):
    X, Y, w = _data(m)
    cfg = T.CVConfig(dtype=dtype)
    return cfg, T.fit(cfg, X, Y, w, device="cpu")


@pytest.mark.parametrize("n_components, match", [
    (0, "n_components"), (K + 1, "n_components"), (-1, "n_components")])
def test_n_components_out_of_range_raises(n_components, match):
    cfg, st = _state()
    with pytest.raises(ValueError, match=match):
        T.cross_validate_pls(cfg, st, np.arange(N)[:, None],
                             n_components=n_components)


def test_n_components_over_the_training_rows_raises():
    X, Y, w = _data(2, n=12, k=10)
    cfg = T.CVConfig()
    st = T.fit(cfg, X, Y, w, device="cpu")
    idx = np.arange(12).reshape(2, 6)  # 6 training rows a fold
    assert T.cross_validate_pls(cfg, st, idx, n_components=6).shape == (
        2, 6, 2)
    with pytest.raises(ValueError, match="training rows"):
        T.cross_validate_pls(cfg, st, idx, n_components=7)


def test_bad_inputs_raise():
    cfg, st = _state()
    idx = np.arange(N)[:, None]
    with pytest.raises(TypeError):
        T.cross_validate_pls(cfg, st, idx, n_components=2.5)
    with pytest.raises(ValueError, match="Unknown impl"):
        T.cross_validate_pls(cfg, st, idx, n_components=2, impl="xla")
    with pytest.raises(ValueError, match="impl='cuda'"):
        T.cross_validate_pls(cfg, st, idx, n_components=2, impl="cuda")
    st_x = T.fit(cfg, _data(2)[0], None, device="cpu")
    with pytest.raises(ValueError, match="Response variables"):
        T.cross_validate_pls(cfg, st_x, idx, n_components=2)
    cfg32, st32 = _state(dtype=np.float32)
    with pytest.raises(ValueError, match="float64"):
        T.cross_validate_pls(cfg32, st32, idx, n_components=2, impl="cuda")
    with pytest.raises(ValueError, match="one of"):
        TS.cross_validate_reduce(cfg, st, idx)
    with pytest.raises(ValueError, match="one of"):
        TS.cross_validate_reduce(cfg, st, idx, reduce_fn=lambda m, s: m[0],
                                 chunk_fn=lambda m, s, r: m[0])


def test_exports_and_counter():
    assert T.cross_validate_pls is TP.cross_validate_pls
    assert "cross_validate_pls" in T.__all__
    from cvmatrix_tpu_torch import models, ops

    assert models.cross_validate_pls is TP.cross_validate_pls
    cfg, st = _state()
    ops.reset_launch_counts()
    T.cross_validate_pls(cfg, st, np.arange(N)[:, None], n_components=2,
                         batch_size=7)  # 5 chunks of 6: 30 folds, 2 each
    assert OP.fold_components() == 60
    assert OP.fold_components("operator") == 60
    assert OP.fold_components("matrices") == 0
    assert ops.launch_counts() == {}  # the twin launches nothing
    ops.reset_launch_counts()
    assert OP.fold_components() == 0


def _span_counts(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    counts = {}
    for e in prof.events():
        if e.name.startswith(P.PREFIX):
            counts[e.name] = counts.get(e.name, 0) + 1
    return counts


def test_spans_a_call_and_a_chunk():
    """Leave-one-out takes the operator route: a solve span a chunk and no
    reduce sweep."""
    cfg, st = _state()
    counts = _span_counts(lambda: T.cross_validate_pls(
        cfg, st, np.arange(N)[:, None], n_components=2, batch_size=7))
    assert counts[P.PLS + "cross_validate_pls"] == 1
    assert counts[P.PLS_SOLVE] == 5
    assert P.SWEEP + "cross_validate_reduce" not in counts
    assert P.REDUCE_FN not in counts


def test_spans_of_the_formed_route():
    """K-fold takes the reduce sweep: its span once, a solve span a
    chunk."""
    cfg, st = _state()
    idx, _, _ = _folds("small")
    counts = _span_counts(lambda: T.cross_validate_pls(
        cfg, st, idx, n_components=2, batch_size=4))
    assert counts[P.PLS + "cross_validate_pls"] == 1
    assert counts[P.PLS_SOLVE] == 3
    assert counts[P.SWEEP + "cross_validate_reduce"] == 1


@pytest.mark.parametrize("scheme, impl", [
    ("loocv", "auto"), ("kfold", "auto"), ("small", "auto"),
    ("masked", "auto"), ("masked", "torch")])
def test_reduce_without_a_consumer_is_unchanged(monkeypatch, scheme, impl):
    """With a ``reduce_fn`` the sweep gathers no validation rows and copies
    no rows beyond its bodies' own: its operators are those of the same
    sweep with the consumer's helpers made to fail, and the per-fold
    results are bitwise those of the per-fold reduction."""
    cfg, st = _state(3)
    idx, mask, _ = _folds(scheme)

    def fn(mats, stats):
        return mats[0].sum(0) + mats[1].sum()

    def ops_of(call):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = call()
        return out, [e.name for e in prof.events()
                     if not e.name.startswith(P.PREFIX)]

    out, names = ops_of(lambda: TS.cross_validate_reduce(
        cfg, st, idx, mask, reduce_fn=fn, batch_size=4, impl=impl))

    def fail(*a, **k):
        raise AssertionError("gathered validation rows without a consumer")

    monkeypatch.setattr(TB, "_validation_rows", fail)
    calls = []

    def copied_rows(*a, _fn=TB._copied_rows, **k):
        rows_of = _fn(*a, **k)
        return lambda *b: calls.append(1) or rows_of(*b)
    monkeypatch.setattr(TB, "_copied_rows", copied_rows)
    out2, names2 = ops_of(lambda: TS.cross_validate_reduce(
        cfg, st, idx, mask, reduce_fn=fn, batch_size=4, impl=impl))
    assert names2 == names and torch.equal(out, out2)
    assert calls == []  # the sweep's own copy of rows is the consumer's


def test_consumer_sees_the_chunk_and_its_rows():
    """The chunk consumer's rows are the folds' rows of X, Y and the
    weights, and its output is stacked and trimmed to the P folds."""
    cfg, st = _state(3)
    idx, mask, _ = _folds("masked")
    seen = []

    def consume(mats, stats, rows):
        seen.append(rows)
        return rows.X.sum(dim=(1, 2))

    out = TS.cross_validate_reduce(cfg, st, idx, mask, chunk_fn=consume,
                                   batch_size=4)
    assert out.shape == (7,)
    assert len(seen) == 2 and seen[0].X.shape == (4, 5, K)
    got = torch.cat([r.X for r in seen])[:7]
    assert torch.equal(got, st.X[torch.as_tensor(idx)])
    assert torch.equal(torch.cat([r.w for r in seen])[:7],
                       st.weights[torch.as_tensor(idx), 0])
    assert torch.equal(torch.cat([r.mask for r in seen])[:7],
                       torch.as_tensor(mask))


def test_example_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "cvmatrix_tpu_torch.examples."
         "cross_validation_pls", "--device", "cpu"], cwd=ROOT,
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "PRESS: (7, 8, 2)  (n_folds, n_components, M)"
    assert lines[1].startswith("best n_components:")
    gap = float(lines[2].split(":")[1])
    assert gap < 1e-9


def test_api_lists_the_pls_spans():
    text = (ROOT / "docs" / "torch" / "api.md").read_text()
    for name in (P.PLS + "<entry>", P.PLS_SOLVE, P.PLS_WIDE, P.PLS_WIDE_OP):
        assert f"`{name}`" in text, name
    assert "cvmatrix_tpu_torch.examples.cross_validation_pls" in text


# ---- on the card: the kernel ------------------------------------------- #

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("ddof", [0, 1])
@pytest.mark.parametrize("scheme", ["loocv", "kfold", "masked"])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("flags", FLAGS)
def test_kernel_matches_reference(dev, flags, weighted, m, scheme, ddof):
    """Leave-one-out runs the operator kernel, the other schemes the kernel
    on formed matrices, one launch a chunk of 4."""
    OP.reset_launch_counts()
    got, ref = _run(dev, flags, weighted, m, scheme, ddof)
    assert got.device.type == "cuda"
    chunks = -(-len(ref) // 4)
    if scheme == "loocv":
        assert (OP.ikpls2_operator.launches, OP.ikpls2.launches) == (chunks, 0)
    else:
        assert (OP.ikpls2_operator.launches, OP.ikpls2.launches) == (0, chunks)
    assert _gap(got, ref) <= PRESS_TOL


@pytest.mark.cuda
def test_kernel_matches_twin_full_width(dev):
    """K=500, M=10, A=20 on one chunk of LOOCV folds, every flag on and
    weighted: the kernel against the twin on the same operands."""
    rng = np.random.default_rng(11)
    n = 4000
    X = rng.uniform(size=(n, 500))
    Y = rng.uniform(size=(n, 10))
    w = rng.uniform(size=n)
    cfg = T.CVConfig()
    st = T.fit(cfg, X, Y, w, device=dev)
    got = {}
    for impl in ("cuda", "torch"):
        got[impl] = []

        def consume(mats, stats, rows, _impl=impl):
            out = TP.solve(cfg, mats, stats, rows, n_components=20,
                           impl=_impl)
            got[_impl].append(out)
            return out

        TS.cross_validate_reduce(cfg, st, np.arange(0, n, 8)[:, None],
                                 chunk_fn=consume, batch_size=250)
    a = torch.cat(got["cuda"])
    b = torch.cat(got["torch"])
    torch.cuda.synchronize()
    assert torch.isfinite(a).all()
    scale = b.abs().amax(dim=(1, 2), keepdim=True)
    assert float(((a - b).abs() / scale).max()) <= 1e-10


@pytest.mark.cuda
def test_kernel_limits_raise(dev):
    X, Y, w = _data(2)
    cfg = T.CVConfig()
    st = T.fit(cfg, X, np.tile(Y, (1, 17)), w, device=dev)  # M = 34
    with pytest.raises(ValueError, match="M <= 32"):
        T.cross_validate_pls(cfg, st, np.arange(N)[:, None], n_components=2)
    got = T.cross_validate_pls(cfg, st, np.arange(N)[:, None],
                               n_components=2, impl="torch")
    assert got.shape == (N, 2, 34)


@pytest.mark.cuda
def test_float32_on_the_card_needs_the_twin(dev):
    """No float32 kernel: a float32 state on the card raises under "auto"
    and "cuda", and runs the twin, launching no ``ikpls2``, only under
    "torch"."""
    X, Y, w = _data(3)
    cfg = T.CVConfig(dtype=np.float32)
    st = T.fit(cfg, X, Y, w, device=dev)
    idx = np.arange(N)[:, None]
    for impl in ("auto", "cuda"):
        with pytest.raises(ValueError, match="impl='torch'"):
            T.cross_validate_pls(cfg, st, idx, n_components=2, impl=impl)
    OP.reset_launch_counts()
    got = T.cross_validate_pls(cfg, st, idx, n_components=2, impl="torch")
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert OP.ikpls2.launches == 0 and OP.fold_components() == 2 * N


@pytest.mark.cuda
def test_reduce_without_a_consumer_launches_no_pls(dev):
    """The LOOCV reduce sweep with a reduction launches one LOOCV kernel a
    chunk and no ``ikpls2``, as before the consumer existed."""
    from cvmatrix_tpu_torch import ops

    X, Y, w = _data(3, n=300, k=40)
    cfg = T.CVConfig()
    st = T.fit(cfg, X, Y, w, device=dev)
    ops.reset_launch_counts()
    TS.cross_validate_reduce(cfg, st, np.arange(300)[:, None],
                             reduce_fn=lambda m, s: m[0].sum(0),
                             batch_size=64)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"fused_loocv": 5, "fused_loocv_stats": 5}


# ---- on the card: the operator kernel ------------------------------------ #

def _operator_case(dev, n, k, m, A, rows, seed=0):
    """The operator kernel and its twin, both on the card, on the folds
    ``rows`` of uniform data (weighted, every flag on, ddof 1)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, k))
    Y = rng.uniform(size=(n, m))
    w = rng.uniform(size=n)
    cfg = T.CVConfig()
    st = T.fit(cfg, X, Y, w, device=dev)
    sums = (st.sum_X, st.sum_sq_X, st.sum_Y, st.sum_sq_Y, st.sum_w,
            st.num_nonzero_w)
    kw = dict(n_components=A, center_X=True, center_Y=True, scale_X=True,
              scale_Y=True, ddof=1, resolution=cfg.resolution)
    r = torch.as_tensor(rows, device=dev)
    got = OP.ikpls2_operator(st.XTX, st.XTY, st.X, st.Y, st.weights, sums,
                             r, impl="cuda", **kw)
    ref = OP.ikpls2_operator_reference(st.XTX, st.XTY, st.X, st.Y,
                                       st.weights, sums, r, **kw)
    torch.cuda.synchronize()
    return got, ref


@pytest.mark.cuda
@pytest.mark.parametrize("n, k, m, A, rows", [
    (100_000, 500, 10, 20, range(0, 511)),  # the cell: first chunk
    (100_000, 500, 10, 20, range(195 * 511, 100_000)),  # and last (355)
    (4_000, 500, 10, 20, range(13)),  # 13 folds: a group of 8 and 5
    (4_000, 37, 3, 5, range(100)),    # K no multiple of the MMA's 8
    (4_000, 200, 1, 10, range(64)),   # M = 1
    (4_000, 200, 32, 10, range(64)),  # M = 32
], ids=["cell_first", "cell_last", "folds_13", "k_37", "m_1", "m_32"])
def test_operator_kernel_matches_twin(dev, n, k, m, A, rows):
    """Every fold's PRESS within 1e-12 of its largest."""
    got, ref = _operator_case(dev, n, k, m, A, list(rows))
    assert got.shape == ref.shape == (len(rows), A, m)
    assert bool(torch.isfinite(got).all())
    scale = ref.abs().amax(dim=(1, 2), keepdim=True)
    assert float(((got - ref).abs() / scale).max()) <= 1e-12


@pytest.mark.cuda
def test_cell_shape_launches_only_the_operator_kernel(dev):
    """N = 100,000 leave-one-out at K = 500, M = 10, A = 20 in chunks of
    512: 196 launches of ikpls2_op and no other kernel of the port, and one
    wave of clusters a chunk."""
    from cvmatrix_tpu_torch import ops

    rng = np.random.default_rng(3)
    n = 100_000
    cfg = T.CVConfig()
    st = T.fit(cfg, rng.uniform(size=(n, 500)), rng.uniform(size=(n, 10)),
               rng.uniform(size=n), device=dev)
    ops.reset_launch_counts()
    press = T.cross_validate_pls(cfg, st, np.arange(n)[:, None],
                                 n_components=20, batch_size=512)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"ikpls2_op": 196}
    assert OP.fold_components("operator") == n * 20
    assert OP.fold_components("matrices") == 0
    assert press.shape == (n, 20, 10) and bool(torch.isfinite(press).all())
    assert 8 * OP.max_active_clusters(500, 10, dev) >= 511


# ---- on the card: the wide route ------------------------------------------ #

ALL_ON = dict(center_X=True, center_Y=True, scale_X=True, scale_Y=True)


def _reference_on(X, Y, w, val, n_components, flags=ALL_ON, ddof=1):
    """The reference of each fold ``val`` on the inputs' device."""
    return torch.stack([fold_press(X, Y, w, v, n_components=n_components,
                                   ddof=ddof, **flags) for v in val])


def _wide_chunk(dev, n, k, m, A, n_folds, seed=0):
    """Uniform data (weighted, every flag on, ddof 1), one chunk of
    ``n_folds`` K-fold folds through the sweep: the wide kernels twice and
    the twin on the same formed matrices, and each fold's reference."""
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.uniform(size=(n, k)), device=dev)
    Y = torch.as_tensor(rng.uniform(size=(n, m)), device=dev)
    w = torch.as_tensor(rng.uniform(size=n), device=dev)
    cfg = T.CVConfig()
    st = T.fit(cfg, X, Y, w)
    idx = np.arange(n).reshape(-1, n_folds).T.copy()
    got = {}

    def consume(mats, stats, rows):
        args = (*mats, rows.X, rows.Y, rows.w, rows.mask, stats)
        got["cuda"] = OP.ikpls2_wide(*args, n_components=A, impl="cuda",
                                     **ALL_ON)
        got["again"] = OP.ikpls2_wide(*args, n_components=A, impl="cuda",
                                      **ALL_ON)
        got["twin"] = OP.ikpls2_reference(*args, n_components=A, **ALL_ON)
        return got["cuda"]

    OP.reset_launch_counts()
    TS.cross_validate_reduce(cfg, st, idx, chunk_fn=consume,
                             batch_size=n_folds)
    torch.cuda.synchronize()
    assert OP.launch_counts()["ikpls2_wide"] == 2 * (2 * A + 2)
    del st
    got["ref"] = _reference_on(X, Y, w, list(idx), A)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n, k, m, A", [
    (1_000, 8_193, 1, 20),   # one column over ikpls2's limit
    (1_000, 20_000, 1, 20),  # the cell's width
    (600, 8_193, 3, 6),      # M > 1: Jacobi
], ids=["k_8193", "k_20000", "k_8193_m3"])
def test_wide_kernels_match_twin_and_reference(dev, n, k, m, A):
    """Two folds: the kernels within 1e-10 of the twin on the same formed
    matrices and within ``PRESS_TOL`` of the reference, the same bits on a
    second call."""
    got = _wide_chunk(dev, n, k, m, A, 2)
    a, b = got["cuda"], got["twin"]
    assert a.shape == (2, A, m) and bool(torch.isfinite(a).all())
    assert torch.equal(a, got["again"])
    assert _gap(a, b) <= 1e-10, (_gap(a, b), _gap(b, got["ref"]))
    assert _gap(a, got["ref"]) <= PRESS_TOL, (_gap(a, got["ref"]),
                                              _gap(b, got["ref"]))


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["kfold", "masked"])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("flags", FLAGS)
def test_wide_route_on_the_card(dev, monkeypatch, flags, weighted, m,
                                scheme):
    """``MAX_K`` lowered below K = 120: ``cross_validate_pls`` launches the
    wide operator kernels, 3 A + 2 a chunk and no other, within
    ``PRESS_TOL`` of the reference."""
    monkeypatch.setattr(OP, "MAX_K", WK - 1)
    X, Y, w = _data(m, n=WN, k=WK, seed=4)
    if not weighted:
        w = None
    cfg = T.CVConfig(*flags, ddof=1)
    st = T.fit(cfg, X, Y, w, device=dev)
    if scheme == "masked":
        idx, mask, val = _folds("masked", n=WN)
    else:
        idx = np.arange(WN).reshape(-1, WP).T.copy()
        mask, val = None, list(idx)
    OP.reset_launch_counts()
    got = T.cross_validate_pls(cfg, st, idx, mask, n_components=WA,
                               batch_size=3)
    torch.cuda.synchronize()
    chunks = -(-len(val) // 3)
    assert OP.launch_counts() == {"ikpls2": 0, "ikpls2_op": 0,
                                  "ikpls2_wide": 0,
                                  "ikpls2_wide_op": chunks * (3 * WA + 2)}
    ref = _reference(X, Y, w, val, flags, 1, n_components=WA)
    assert got.device.type == "cuda"
    assert _gap(got, ref) <= PRESS_TOL


@pytest.mark.cuda
def test_wide_kernels_m_32_and_odd_shapes(dev):
    """M = 32 (Jacobi's widest), K = 1,337 and L = 33 (no multiple of any
    tile), 3 folds, against the twin; the same bits on a second call."""
    rng = np.random.default_rng(8)
    n, k, m, A = 99, 1_337, 32, 5
    X = torch.as_tensor(rng.uniform(size=(n, k)), device=dev)
    Y = torch.as_tensor(rng.uniform(size=(n, m)), device=dev)
    cfg = T.CVConfig()
    st = T.fit(cfg, X, Y, torch.as_tensor(rng.uniform(size=n), device=dev))
    idx = np.arange(n).reshape(-1, 3).T.copy()
    mats, stats = TB.training_matrices_batched(cfg, st, idx)
    rows = TB._copied_rows(cfg, st, idx, None)(0, 3)
    args = (*mats, rows.X, rows.Y, rows.w, rows.mask, stats)
    a = OP.ikpls2_wide(*args, n_components=A, impl="cuda", **ALL_ON)
    a2 = OP.ikpls2_wide(*args, n_components=A, impl="cuda", **ALL_ON)
    b = OP.ikpls2_reference(*args, n_components=A, **ALL_ON)
    torch.cuda.synchronize()
    assert torch.equal(a, a2)
    assert _gap(a, b) <= 1e-10


@pytest.mark.cuda
def test_wide_solve_launches_only_its_named_kernels(dev, tmp_path):
    """Under the profiler every device operation of one wide solve is one
    of its kernels, each named ``ikpls2_wide``: 2 A + 2 of them."""
    import json

    rng = np.random.default_rng(2)
    n, k, A = 200, 9_000, 4
    cfg = T.CVConfig()
    st = T.fit(cfg, rng.uniform(size=(n, k)), rng.uniform(size=(n, 1)),
               rng.uniform(size=n), device=dev)
    idx = np.arange(n).reshape(-1, 2).T.copy()
    mats, stats = TB.training_matrices_batched(cfg, st, idx)
    rows = TB._copied_rows(cfg, st, idx, None)(0, 2)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        OP.ikpls2_wide(*mats, rows.X, rows.Y, rows.w, rows.mask, stats,
                       n_components=A, impl="cuda", **ALL_ON)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ops = [e["name"] for e in events if e.get("ph") == "X" and e.get("cat")
           in ("kernel", "gpu_memcpy", "gpu_memset")]
    assert len(ops) == 2 * A + 2, ops
    assert all("ikpls2_wide" in name for name in ops), ops
    spans = [e for e in events if e.get("name") == P.PLS_WIDE
             and e.get("cat") == "user_annotation"]
    assert len(spans) == 1


@pytest.mark.cuda
def test_cell_shape_takes_the_wide_route(dev):
    """The cell's shape: N = 5,000, K = 20,000, M = 1, A = 20, 10 folds in
    chunks of 2 through ``cross_validate_pls(impl="auto")``: 5 x 62 wide
    operator launches, 200 fold-components on that route and none on the
    others; folds 0 and 9 against the reference."""
    rng = np.random.default_rng(5)
    n, k = 5_000, 20_000
    X = torch.as_tensor(rng.uniform(size=(n, k)), device=dev)
    Y = torch.as_tensor(rng.uniform(size=(n, 1)), device=dev)
    w = torch.as_tensor(rng.uniform(size=n), device=dev)
    cfg = T.CVConfig()
    st = T.fit(cfg, X, Y, w)
    idx = np.arange(n).reshape(-1, 10).T.copy()
    OP.reset_launch_counts()
    press = T.cross_validate_pls(cfg, st, idx, n_components=20, batch_size=2)
    torch.cuda.synchronize()
    assert OP.launch_counts() == {"ikpls2": 0, "ikpls2_op": 0,
                                  "ikpls2_wide": 0, "ikpls2_wide_op": 5 * 62}
    assert OP.fold_components("wide_op") == 200
    assert OP.fold_components("wide") == 0
    assert OP.fold_components("matrices") == 0
    assert OP.fold_components("operator") == 0
    assert press.shape == (10, 20, 1) and bool(torch.isfinite(press).all())
    del st
    ref = _reference_on(X, Y, w, [idx[0], idx[9]], 20)
    assert _gap(press[[0, 9]], ref) <= PRESS_TOL


# ---- on the card: the wide operator route ---------------------------------- #

def _wide_op_on(dev, n, k, m, A, n_folds, n_l=None, weighted=True,
                masked=False, seed=0, flags=ALL_ON):
    """Uniform data, ``n_folds`` folds of ``n_l`` rows (strided, the
    default n / n_folds; a mask that drops each fold's last row where
    ``masked``): ``ops.pls.ikpls2_wide_op``'s kernels twice and its twin,
    on the card, and each fold's reference."""
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.uniform(size=(n, k)), device=dev)
    Y = torch.as_tensor(rng.uniform(size=(n, m)), device=dev)
    w = (torch.as_tensor(rng.uniform(size=n), device=dev) if weighted
         else None)
    cfg = T.CVConfig(*flags.values(), ddof=1)
    st = T.fit(cfg, X, Y, w)
    n_l = n // n_folds if n_l is None else n_l
    idx = np.arange(n_folds * n_l).reshape(n_l, n_folds).T.copy()
    mask = None
    if masked:
        mask = np.ones(idx.shape)
        mask[:, -1] = 0.0
    sums = (st.sum_X, st.sum_sq_X, st.sum_Y, st.sum_sq_Y, st.sum_w,
            st.num_nonzero_w)
    rows = torch.as_tensor(idx, device=dev)
    mk = None if mask is None else torch.as_tensor(mask, device=dev)
    kw = dict(n_components=A, ddof=1, resolution=cfg.resolution, **flags)
    args = (st.XTX, st.XTY, st.X, st.Y, st.weights, sums, rows, mk)
    OP.reset_launch_counts()
    got = {"cuda": OP.ikpls2_wide_op(*args, impl="cuda", **kw),
           "again": OP.ikpls2_wide_op(*args, impl="cuda", **kw)}
    torch.cuda.synchronize()
    assert OP.launch_counts()["ikpls2_wide_op"] == 2 * (3 * A + 2)
    got["twin"] = OP.ikpls2_wide_op_reference(*args, **kw)
    torch.cuda.synchronize()
    del st
    val = [row if mask is None else row[mask[f] == 1]
           for f, row in enumerate(idx)]
    got["ref"] = _reference_on(X, Y, w, val, A,
                               flags={k_: v for k_, v in flags.items()})
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n, k, m, A, n_folds, n_l, masked, weighted", [
    (1_000, 8_193, 1, 20, 2, None, False, True),   # one column over ikpls2's
    (1_000, 20_000, 1, 20, 2, None, False, True),  # the cell's width
    (600, 8_193, 3, 6, 3, None, True, True),       # M > 1, masked, 3 folds
    (600, 8_193, 1, 6, 1, 300, False, False),      # one fold, unweighted
    (990, 9_000, 2, 5, 5, None, True, False),      # 5 folds: two groups
], ids=["k_8193", "k_20000", "m3_masked_f3", "f1_unweighted", "f5"])
def test_wide_op_kernels_match_twin_and_reference(dev, n, k, m, A, n_folds,
                                                  n_l, masked, weighted):
    """The kernels (the total's upper triangle read once a group of folds
    and component) within 1e-12 of the twin (which reads the whole total)
    on each fold's largest PRESS, the same bits on a second call, and
    within ``PRESS_TOL`` of the reference."""
    got = _wide_op_on(dev, n, k, m, A, n_folds, n_l=n_l, masked=masked,
                      weighted=weighted)
    a, b = got["cuda"], got["twin"]
    assert a.shape == (n_folds, A, m) and bool(torch.isfinite(a).all())
    assert torch.equal(a, got["again"])
    assert _gap(a, b) <= 1e-12, (_gap(a, b), _gap(b, got["ref"]))
    assert _gap(a, got["ref"]) <= PRESS_TOL, (_gap(a, got["ref"]),
                                              _gap(b, got["ref"]))


@pytest.mark.cuda
@pytest.mark.parametrize("flags", FLAGS)
def test_wide_op_kernels_every_flag_set(dev, flags):
    """K = 1,337 and L = 33 (no multiple of any tile), M = 32 (Jacobi's
    widest), 3 folds, every flag set: the kernels within 1e-12 of the
    twin."""
    fl = dict(zip(("center_X", "center_Y", "scale_X", "scale_Y"), flags))
    got = _wide_op_on(dev, 99, 1_337, 32, 5, 3, n_l=33, flags=fl, seed=8)
    assert torch.equal(got["cuda"], got["again"])
    assert _gap(got["cuda"], got["twin"]) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["kfold", "masked", "loocv"])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("flags", FLAGS)
def test_wide_op_route_on_the_card(dev, monkeypatch, flags, weighted, m,
                                   scheme):
    """``MAX_K`` (and ``MAX_OP_K``) lowered below K = 120: every bucket
    launches the wide operator kernels, 3 A + 2 a chunk and no other,
    within ``OP_TOL`` of the formed route's twin and ``PRESS_TOL`` of the
    reference."""
    monkeypatch.setattr(OP, "MAX_K", WK - 1)
    monkeypatch.setattr(OP, "MAX_OP_K", WK - 1)
    OP.reset_launch_counts()
    got, formed, ref = _wide_op_case(flags, weighted, m, scheme, 1, dev=dev)
    torch.cuda.synchronize()
    chunks = -(-len(ref) // 3)
    assert OP.launch_counts() == {"ikpls2": 0, "ikpls2_op": 0,
                                  "ikpls2_wide": 0,
                                  "ikpls2_wide_op": chunks * (3 * WA + 2)}
    assert got.device.type == "cuda"
    assert _gap(got, formed) <= OP_TOL
    assert _gap(got, ref) <= PRESS_TOL


@pytest.mark.cuda
def test_wide_op_solve_launches_only_its_named_kernels(dev, tmp_path):
    """Under the profiler every device operation of one wide operator
    solve, in its span, is one of its kernels, each named
    ``ikpls2_wide``: 3 A + 2 of them, the gather of the rows included. One
    solve runs before the profiler starts and one in its warm-up step,
    whose events it discards: launches soon after tracing starts can go
    unrecorded, on cold kernels and in a long run of tests alike."""
    import json

    rng = np.random.default_rng(2)
    n, k, A = 200, 9_000, 4
    cfg = T.CVConfig()
    st = T.fit(cfg, rng.uniform(size=(n, k)), rng.uniform(size=(n, 1)),
               rng.uniform(size=n), device=dev)
    idx = np.arange(n).reshape(-1, 2).T.copy()
    rows = torch.as_tensor(idx, device=dev)
    TP.solve_wide_operator(cfg, st, rows, None, n_components=A)
    torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
            on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
        for _ in range(2):
            TP.solve_wide_operator(cfg, st, rows, None, n_components=A)
            torch.cuda.synchronize()
            prof.step()
    events = json.loads(path.read_text())["traceEvents"]
    ops = [e["name"] for e in events if e.get("ph") == "X" and e.get("cat")
           in ("kernel", "gpu_memcpy", "gpu_memset")]
    assert len(ops) == 3 * A + 2, ops
    assert all("ikpls2_wide" in name for name in ops), ops
    spans = [e for e in events if e.get("name") == P.PLS_WIDE_OP
             and e.get("cat") == "user_annotation"]
    assert len(spans) == 1
