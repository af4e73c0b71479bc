"""The port's materialising sweep against the JAX package's, the K-fold
routes' probes against the per-fold engine, and the whole LOOCV slice
(fit -> Partitioner -> sources -> chunked downdate) against the NumPy
oracle."""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import cvmatrix_tpu as J
import cvmatrix_tpu_torch as T
from cvmatrix_tpu.models import sweep as JS
from cvmatrix_tpu_torch.core import batch as TB
from cvmatrix_tpu_torch.models import sweep as TS

from .data import make_dataset, zero_fraction
from .oracle import NaiveOracle

X_ALL, Y_ALL, FOLDS, WEIGHTS = make_dataset(n=41, k=5, m=2)
N = X_ALL.shape[0]


def probes(flags, idx, mask=None, weighted=True, **kw):
    w = zero_fraction(WEIGHTS) if weighted else None
    got = TS.materialize_cv(T.CVConfig(*flags), X_ALL, Y_ALL, w, idx, mask,
                            device="cpu", **kw)
    ref = JS.materialize_cv(J.CVConfig(*flags), X_ALL, Y_ALL, w, idx, mask,
                            **kw)
    return float(got), float(ref)


@pytest.mark.parametrize("batch_size", [None, 10])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("flags", [(True,) * 4, (False,) * 4,
                                   (True, False, False, True),
                                   (False, True, True, False)])
def test_loocv_probe_matches_jax(flags, weighted, batch_size):
    """All-row LOOCV at the same chunking (41 folds in chunks of 10 pad to
    50 by repeating the last fold; the probe reads the last chunk)."""
    got, ref = probes(flags, np.arange(N)[:, None], weighted=weighted,
                      batch_size=batch_size)
    assert_allclose(got, ref, atol=1e-8, rtol=0)


@pytest.mark.parametrize("xtx_only", [False, True])
def test_loocv_probe_xtx_only_matches_jax(xtx_only):
    got, ref = probes((True, True, False, True), np.arange(N)[:, None],
                      batch_size=7, return_XTY=not xtx_only)
    assert_allclose(got, ref, atol=1e-8, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_fold_engine_probe_matches_jax(masked):
    """Multi-row folds take the per-fold engine on the CPU."""
    if masked:
        _, idx, mask = J.Partitioner(FOLDS).padded_batches()
    else:
        idx = np.arange(40).reshape(8, 5)
        mask = None
    got, ref = probes((True, True, True, True), idx, mask, batch_size=3)
    assert_allclose(got, ref, atol=1e-8, rtol=0)


X_K, Y_K, FOLDS_K, W_K = make_dataset(n=200, k=5, m=2)

# name: (fold batch, mask, matmul_mode, return_XTX, the port's route)
KFOLD_CASES = {
    "packed": (np.arange(200).reshape(50, 4), None, "auto", True, "packed"),
    "packed_masked": (np.arange(200).reshape(40, 5), "drop1", "auto", True,
                      "packed"),
    "v3": (np.arange(200).reshape(10, 20), None, "auto", True, "v3"),
    "v3_masked": (None, "folds", "auto", True, "v3"),
    "ozaki_df64_xty": (np.arange(200).reshape(5, 40), None, "auto", False,
                       "ozaki_df64"),
    "epilogue_masked": (np.arange(200).reshape(5, 40), "drop1", "native",
                        True, "epilogue"),
}


@pytest.mark.parametrize("case", sorted(KFOLD_CASES))
def test_kfold_probe_matches_jax_and_fold_engine(case):
    """K-fold sweeps through each route (the twins on the CPU): the probe
    against the JAX package's XLA sweep and against the per-fold engine
    on the probe fold."""
    idx, mask, mode, xtx, route = KFOLD_CASES[case]
    if mask == "folds":
        _, idx, mask = T.Partitioner(FOLDS_K).padded_batches()
    elif mask == "drop1":
        mask = np.ones(idx.shape)
        mask[::3, -1] = 0.0
    flags = (True, True, True, True)
    w = zero_fraction(W_K)
    cfg = T.CVConfig(*flags, matmul_mode=mode)
    st = T.fit(cfg, X_K, Y_K, w, device="cpu")
    assert TB.route_kernel(cfg, st, idx.shape[1], xtx, True,
                           mask is not None) == route
    kw = dict(batch_size=3, return_XTX=xtx)
    got = TS.materialize_cv(cfg, X_K, Y_K, w, idx, mask, device="cpu",
                            **kw)
    ref = JS.materialize_cv(J.CVConfig(*flags, matmul_mode=mode), X_K, Y_K,
                            w, idx, mask, impl="xla", **kw)
    assert_allclose(float(got), float(ref), atol=1e-8, rtol=0)
    bs, n_chunks = TS.chunking(idx.shape[0], 5, (5 if xtx else 0) + 2, 3)
    f = min((n_chunks - 1) * bs, idx.shape[0] - 1)
    mats, _ = T.training_matrices(cfg, st, idx[f],
                                  None if mask is None else mask[f],
                                  return_XTX=xtx)
    expect = (mats[0][0, 0] + mats[1][0, 0]) if xtx else mats[0, 0]
    assert_allclose(float(got), float(expect), atol=1e-10, rtol=0)


X32, Y32, W32 = (a.astype(np.float32) for a in (X_K, Y_K, zero_fraction(W_K)))

# name: (fold batch, mask, return_XTX, the port's float32 route)
F32_CASES = {
    "loocv": (np.arange(200)[:, None], None, True, "loocv"),
    "packed_f32_xty": (np.arange(200)[:, None], None, False, "packed_f32"),
    "packed_f32": (np.arange(200).reshape(50, 4), None, True, "packed_f32"),
    "packed_f32_masked": (np.arange(200).reshape(40, 5), "drop1", True,
                          "packed_f32"),
    "downdate_f32": (np.arange(200).reshape(5, 40), None, True,
                     "downdate_f32"),
    "downdate_f32_masked": (None, "folds", True, "downdate_f32"),
}


@pytest.mark.parametrize("case", sorted(F32_CASES))
def test_f32_probe_matches_jax_and_fold_engine(case):
    """Float32 sweeps through each f32 route (the twins on the CPU):
    materialize_cv and materialize_sweep against the JAX package's XLA
    f32 sweep, and the probe against the per-fold engine on the probe
    fold, at 1e-4 relative (float32 sums in another order)."""
    idx, mask, xtx, route = F32_CASES[case]
    if mask == "folds":
        _, idx, mask = T.Partitioner(FOLDS_K).padded_batches()
    elif mask == "drop1":
        mask = np.ones(idx.shape, np.float32)
        mask[::3, -1] = 0.0
    flags = (True, True, True, True)
    cfg = T.CVConfig(*flags, dtype=np.float32)
    jcfg = J.CVConfig(*flags, dtype=np.float32)
    st = T.fit(cfg, X32, Y32, W32, device="cpu")
    assert TB.route_kernel(cfg, st, idx.shape[1], xtx, True,
                           mask is not None) == route
    kw = dict(batch_size=3, return_XTX=xtx)
    got = TS.materialize_cv(cfg, X32, Y32, W32, idx, mask, device="cpu",
                            **kw)
    ref = JS.materialize_cv(jcfg, X32, Y32, W32, idx, mask, impl="xla", **kw)
    assert got.dtype == torch.float32
    assert_allclose(float(got), float(ref), rtol=1e-4)
    js = J.fit(jcfg, X32, Y32, W32)
    got_sweep = TS.materialize_sweep(cfg, T.FitState.from_numpy({
        f: None if getattr(js, f) is None else np.asarray(getattr(js, f))
        for f in js.__dataclass_fields__}), idx, mask, **kw)
    ref_sweep = JS.materialize_sweep(jcfg, js, idx, mask, impl="xla", **kw)
    assert_allclose(float(got_sweep), float(ref_sweep), rtol=1e-4)
    bs, n_chunks = TS.chunking(idx.shape[0], 5, (5 if xtx else 0) + 2, 3)
    f = min((n_chunks - 1) * bs, idx.shape[0] - 1)
    mats, _ = T.training_matrices(cfg, st, idx[f],
                                  None if mask is None else mask[f],
                                  return_XTX=xtx)
    expect = (mats[0][0, 0] + mats[1][0, 0]) if xtx else mats[0, 0]
    assert_allclose(float(got), float(expect), rtol=1e-4)


@pytest.mark.parametrize("sweep", ["materialize", "reduce"])
@pytest.mark.parametrize("route", ["epilogue", "downdate_f32"])
def test_large_fold_sweep_builds_total_once(monkeypatch, route, sweep):
    """The large-fold sweeps (the ``bmm`` + epilogue route and
    ``fused_downdate``; materialize_sweep's branch and the generic body of
    cross_validate_reduce) build [XTX | XTY] once for their three chunks,
    not once a chunk; the result still matches the JAX package's sweep:
    the probe at 1e-8 absolute in float64 and 1e-4 relative in float32,
    every fold's matrices at 1e-10 of the largest entry in float64 and at
    5e-4 in float32 (on this data the port's float32 matrices are 2.5e-4
    of the largest entry off its float64 ones, the JAX package's 3.4e-4)."""
    f32 = route == "downdate_f32"
    data = (X32, Y32, W32) if f32 else (X_K, Y_K, zero_fraction(W_K))
    kw = dict(dtype=np.float32) if f32 else dict(matmul_mode="native")
    cfg = T.CVConfig(True, True, True, True, **kw)
    jcfg = J.CVConfig(True, True, True, True, **kw)
    idx = np.arange(200).reshape(5, 40)
    st = T.fit(cfg, *data, device="cpu")
    assert TB.route_kernel(cfg, st, 40, True, True, False) == route
    assert TS.chunking(5, 5, 7, 2) == (2, 3)
    calls = []
    orig = TB._total

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(TB, "_total", counted)
    if sweep == "materialize":
        got = float(TS.materialize_sweep(cfg, st, idx, batch_size=2))
        ref = float(JS.materialize_cv(jcfg, *data, idx, batch_size=2,
                                      impl="xla"))
    else:  # every fold's matrices, the reduction the identity
        got = torch.cat(TS.cross_validate_reduce(
            cfg, st, idx, batch_size=2, reduce_fn=lambda mats, stats: mats),
            dim=2).numpy()
        ref = np.concatenate(JS.cross_validate_reduce(
            jcfg, J.fit(jcfg, *data), idx, batch_size=2,
            reduce_fn=lambda mats, stats: mats), axis=2)
        assert got.shape == ref.shape == (5, 5, 7)
    assert len(calls) == 1
    if sweep == "materialize":
        assert_allclose(got, ref, rtol=1e-4) if f32 else assert_allclose(
            got, ref, atol=1e-8, rtol=0)
    else:
        assert_allclose(got, ref, rtol=0,
                        atol=(5e-4 if f32 else 1e-10) * np.abs(ref).max())


def test_chunking_rule():
    """The JAX package's rule: 4 GB / (16 B K C), at most 2000, equalised."""
    assert TS.chunking(100_000, 500, 510) == (971, 103)
    assert TS.chunking(41, 5, 7, batch_size=10) == (9, 5)
    assert TS.chunking(41, 5, 7) == (41, 1)


@pytest.mark.parametrize("n_folds,batch_size", [(41, 10), (40, 10),
                                                 (41, None), (7, 3)])
def test_sweep_last_chunk_holds_the_probe_fold(n_folds, batch_size):
    """The last chunk the sweep runs, padded as it pads, and its first
    fold's XTX[0, 0] + XTY[0, 0] is the sweep's probe (the JAX sweep's)."""
    cfg = T.CVConfig(*(True,) * 4)
    idx = np.arange(n_folds)[:, None]
    chunk = TS.sweep_last_chunk(cfg, idx, 5, 7, batch_size)
    bs, n_chunks = TS.sweep_chunking(cfg, n_folds, 5, 7, batch_size)
    assert chunk.shape == (bs, 1)
    want = np.arange((n_chunks - 1) * bs, n_chunks * bs).clip(max=n_folds - 1)
    np.testing.assert_array_equal(chunk[:, 0], want)
    w = zero_fraction(WEIGHTS)
    st = T.fit(cfg, X_ALL, Y_ALL, w, device="cpu")
    (xtx, xty), _ = T.training_matrices(cfg, st, chunk[0])
    ref = float(JS.materialize_sweep(
        J.CVConfig(*(True,) * 4), J.fit(J.CVConfig(*(True,) * 4), X_ALL,
                                        Y_ALL, w), idx,
        batch_size=batch_size))
    got = float(TS.materialize_sweep(cfg, st, idx, batch_size=batch_size))
    assert_allclose(float(xtx[0, 0] + xty[0, 0]), ref, rtol=1e-10)
    assert_allclose(got, ref, rtol=1e-10)


def test_whole_slice_against_oracle():
    """CVMatrix.fit, Partitioner(np.arange(N)), then prepare_loocv_sources
    and loocv_from_sources chunk by chunk over every fold."""
    flags = (True, True, True, True)
    w = zero_fraction(WEIGHTS)
    cvm = T.CVMatrix(*flags, device="cpu").fit(X_ALL, Y_ALL, w)
    keys, idx, mask = T.Partitioner(np.arange(N)).padded_batches()
    assert mask is None and idx.shape == (N, 1)
    src = TB.prepare_loocv_sources(cvm.config, cvm.state, idx)
    oracle = NaiveOracle(*flags).fit(X_ALL, Y_ALL, w)
    bs = 16
    for start in range(0, N, bs):
        rows = idx[start:start + bs, 0]
        out = TB.loocv_from_sources(cvm.config, src, rows,
                                    src.scal[start:start + bs],
                                    return_XTY=True)
        for f, r in enumerate(rows):
            (xtx, xty), _ = oracle.training_XTX_XTY(np.delete(np.arange(N), r))
            assert_allclose(out[f, :, :5].numpy(), xtx, atol=1e-8, rtol=0)
            assert_allclose(out[f, :, 5:].numpy(), xty, atol=1e-8, rtol=0)


def test_sweep_argument_errors():
    st = T.fit(T.CVConfig(), X_ALL, Y_ALL, WEIGHTS, device="cpu")
    idx = np.arange(N)[:, None]
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        TS.materialize_sweep(T.CVConfig(), st, idx, impl="cuda")
    with pytest.raises(ValueError, match="Unknown impl"):
        TS.materialize_sweep(T.CVConfig(), st, idx, impl="xla")
    with pytest.raises(ValueError, match="Weights must be non-negative"):
        TS.materialize_cv(T.CVConfig(), X_ALL, Y_ALL, -WEIGHTS, idx,
                          device="cpu")
    st_x = T.fit(T.CVConfig(), X_ALL, None, WEIGHTS, device="cpu")
    with pytest.raises(ValueError, match="Response variables"):
        TS.materialize_sweep(T.CVConfig(), st_x, idx)


@pytest.mark.parametrize("impl", ["auto", "torch"])
@pytest.mark.parametrize("flags", [(True, False, True, False),
                                   (True, True, True, False)])
def test_impls_agree_on_cpu(impl, flags):
    """On CPU tensors 'auto' and 'torch' both run the plain twin; (F,)
    one-row fold indices are accepted as (F, 1)."""
    w = zero_fraction(WEIGHTS)
    got = TS.materialize_cv(T.CVConfig(*flags), X_ALL, Y_ALL, w,
                            np.arange(N), impl=impl, batch_size=12,
                            device="cpu")
    ref = JS.materialize_cv(J.CVConfig(*flags), X_ALL, Y_ALL, w,
                            np.arange(N)[:, None], batch_size=12)
    assert_allclose(float(got), float(ref), atol=1e-8, rtol=0)
