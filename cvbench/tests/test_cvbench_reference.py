"""``cvbench/reference.py`` against an independent NumPy computation, and
the traffic generator's folds and samples."""

import itertools

import numpy as np
import pytest
import torch

from cvbench import reference, traffic


def _numpy_fold(X, Y, w, val, flags, ddof):
    """Training matrices written with an explicit diagonal weight matrix
    and the weighted variance sum_i w_i (x_i - m)^2 / ((nnz - ddof) sum_w /
    nnz)."""
    cx, cy, sx, sy = flags
    train = np.setdiff1d(np.arange(X.shape[0]), val)
    Xt, Yt = X[train], Y[train]
    wt = np.ones(len(train)) if w is None else w[train]
    W = np.diag(wt)
    nnz = np.count_nonzero(wt)
    sw = wt.sum()

    def prep(A, center, scale):
        mean = (W @ A).sum(0) / sw
        B = A - mean if center else A
        std = None
        if scale:
            var = (wt[:, None] * (B - (0 if center else mean)) ** 2).sum(0) / (
                (nnz - ddof) * sw / nnz)
            std = np.sqrt(var)
            std[np.abs(std) <= np.finfo(np.float64).resolution * 10] = 1.0
            B = B / std
        return B, (mean if center or scale else None), std

    Xp, xm, xs = prep(Xt, cx, sx)
    Yp, ym, ys = prep(Yt, cy, sy)
    return Xp.T @ W @ Xp, Xp.T @ W @ Yp, (xm, xs, ym, ys)


@pytest.mark.parametrize("flags", list(itertools.product((True, False),
                                                         repeat=4)))
@pytest.mark.parametrize("weighted", [True, False])
def test_fold_against_numpy(flags, weighted):
    rng = np.random.default_rng(5)
    X, Y = rng.random((40, 6)), rng.random((40, 3))
    w = rng.random(40) if weighted else None
    val = np.array([3, 17, 29])
    cfg = dict(zip(("center_X", "center_Y", "scale_X", "scale_Y"), flags),
               ddof=1, dtype="float64")
    xtx, xty, stats = reference.fold(
        torch.from_numpy(X), torch.from_numpy(Y),
        None if w is None else torch.from_numpy(w), val, cfg)
    exx, exy, estats = _numpy_fold(X, Y, w, val, flags, 1)
    np.testing.assert_allclose(xtx.numpy(), exx, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(xty.numpy(), exy, rtol=1e-12, atol=1e-12)
    for got, want in zip(stats, estats):
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_allclose(got.numpy().ravel(), want, rtol=1e-12)
    rows = np.array([0, 4])
    part = reference.fold(torch.from_numpy(X), torch.from_numpy(Y),
                          None if w is None else torch.from_numpy(w), val,
                          cfg, rows)
    np.testing.assert_allclose(part[0].numpy(), exx[rows], rtol=1e-12,
                               atol=1e-12)


def test_fit_rows_against_numpy():
    rng = np.random.default_rng(6)
    X, Y, w = rng.random((30, 5)), rng.random((30, 2)), rng.random(30)
    rows = np.array([1, 3])
    got = reference.fit_rows(*map(torch.from_numpy, (X, Y, w)), rows)
    W = np.diag(w)
    np.testing.assert_allclose(got["XTX"].numpy(), (X.T @ W @ X)[rows])
    np.testing.assert_allclose(got["XTY"].numpy(), (X.T @ W @ Y)[rows])
    np.testing.assert_allclose(got["sum_sq_X"].numpy().ravel(),
                               w @ (X * X))
    np.testing.assert_allclose(float(got["sum_w"]), w.sum())
    low = reference.fit_rows(*map(torch.from_numpy, (X, Y, w)), rows,
                             dtype=torch.float32)
    assert low["XTX"].dtype == torch.float64
    assert 0 < float((low["XTX"] - got["XTX"]).abs().max()) < 1e-4


def test_folds_buckets_chunks_and_rows():
    f = traffic.Folds(10, 3, 1)
    assert f.shapes() == [(1, 4), (2, 3)]
    assert [c.idx.tolist() for c in f.chunks] == [[[0, 3, 6, 9]],
                                                  [[1, 4, 7]], [[2, 5, 8]]]
    assert f.where == {0: (0, 0), 1: (1, 0), 2: (2, 0)}
    np.testing.assert_array_equal(f.rows(2), [2, 5, 8])
    m = traffic.Folds(10, 3, 8, masked=True)
    assert m.shapes() == [(3, 4)]
    assert m.chunks[0].mask.tolist() == [[1, 1, 1, 1], [1, 1, 1, 0],
                                         [1, 1, 1, 0]]
    loocv = traffic.Folds(100_000, 100_000, 980)
    assert [len(c.folds) for c in loocv.chunks] == [980] * 102 + [40]


def test_samples_cycle_chunks_and_repeat_by_seed():
    cfg = {"K": 20}
    f = traffic.Folds(1000, 1000, 10)          # 100 chunks
    seed = 2 ** 31 + 12345
    seen = set()
    for t in range(traffic.CHECK_TOTALS):
        s, again = (traffic.sample(cfg, f, seed, t) for _ in range(2))
        seen.update(f.where[p][0] for p in s.folds)
        assert s.folds == again.folds
        assert np.array_equal(s.fit_rows, again.fit_rows)
    assert seen == set(range(len(f.chunks)))
    X1, _ = traffic.inputs({"N": 5, "K": 3, "M": 1, "dtype": "float64"},
                           seed, torch.device("cpu"))
    X2, _ = traffic.inputs({"N": 5, "K": 3, "M": 1, "dtype": "float64"},
                           seed, torch.device("cpu"))
    assert torch.equal(X1, X2)
    cfg = {"N": 5, "weighted": True, "dtype": "float64"}
    assert not torch.equal(traffic.weights(cfg, seed, 0, "cpu"),
                           traffic.weights(cfg, seed, 1, "cpu"))
