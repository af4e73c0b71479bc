"""The LOOCV route of the port: sources, plain twin and dispatch.

The JAX state is fed to the port through ``FitState.from_numpy`` so the
fold math is held in isolation from the fit. The twin is held against the
JAX package's vmapped engine (``training_matrices_batched(impl="xla")``)
over 16 flags x weights x Y, and against the JAX package's own CPU model
of its Pallas kernel (``fused_loocv_df64_reference``) at 1e-8. The CUDA
kernel itself is checked on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.
"""

import dataclasses
from itertools import product

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import cvmatrix_tpu as J
import cvmatrix_tpu_torch as T
from cvmatrix_tpu.core import batch as JB
from cvmatrix_tpu.ops import kernels as JK
from cvmatrix_tpu.ops.df64 import df_to_f64
from cvmatrix_tpu_torch.core import batch as TB
from cvmatrix_tpu_torch.models import sweep as TS
from cvmatrix_tpu_torch.ops import loocv as TL

from .oracle import NaiveOracle

N, K, M = 70, 9, 4
rng = np.random.default_rng(11)
X_ALL = rng.normal(size=(N, K)) * 3 + 1
Y_ALL = rng.normal(size=(N, M))
W_ALL = rng.uniform(0, 2, size=N)
W_ALL[::7] = 0.0
IDX = np.array([0, 3, 7, 11, 40, 69])


def port_state(js):
    return T.FitState.from_numpy({
        f.name: None if getattr(js, f.name) is None
        else np.asarray(getattr(js, f.name))
        for f in dataclasses.fields(js)
    })


def twin(flags, weighted, with_y, idx=IDX, impl="auto"):
    w = W_ALL if weighted else None
    js = J.fit(J.CVConfig(*flags), X_ALL, Y_ALL if with_y else None, w)
    cfg = T.CVConfig(*flags)
    st = port_state(js)
    assert TB.loocv_single_tile_ok(cfg, st, True, with_y)
    src = TB.prepare_loocv_sources(cfg, st, idx, return_XTY=with_y)
    out = TB.loocv_from_sources(cfg, src, idx, return_XTY=with_y, impl=impl)
    return js, out


@pytest.mark.parametrize("with_y", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("flags", list(product([False, True], repeat=4)))
def test_twin_matches_jax_engine(flags, weighted, with_y):
    js, out = twin(flags, weighted, with_y)
    assert out.shape == (len(IDX), K, K + (M if with_y else 0))
    assert out.dtype == torch.float64
    ref, _ = JB.training_matrices_batched(
        J.CVConfig(*flags), js, IDX[:, None], None,
        return_XTX=True, return_XTY=with_y, impl="xla",
    )
    if with_y:
        ref = np.concatenate([np.asarray(r) for r in ref], axis=2)
    assert_allclose(out.numpy(), np.asarray(ref), atol=1e-8, rtol=0)


@pytest.mark.parametrize("flags", [(True,) * 4, (False,) * 4])
def test_twin_matches_jax_kernel_model(flags):
    """Against the eager CPU model of the Pallas kernel (double-float pairs
    on padded tiles), converted to f64 and trimmed to (K, C)."""
    js, out = twin(flags, True, True, idx=IDX[:3])
    cfg = J.CVConfig(*flags)
    src = JB.prepare_loocv_sources(cfg, js, IDX[:3, None])
    pair = JK.fused_loocv_df64_reference(
        IDX[:3], src.total4, src.xw, src.xu, src.yu, src.yw, src.gx, src.gy,
        src.ymask, src.scal,
        center_xtx=cfg.center_X, center_xty=cfg.center_X or cfg.center_Y,
        scale_x=cfg.scale_X, scale_y=cfg.scale_Y, with_y=True,
        resolution=cfg.resolution,
    )
    ref = np.asarray(df_to_f64(pair[:, 0], pair[:, 1]))[:, :K, :K + M]
    assert_allclose(out.numpy(), ref, atol=1e-8, rtol=0)


def test_sources_are_unpadded_and_aliased():
    cfg = T.CVConfig()
    unweighted = port_state(J.fit(J.CVConfig(), X_ALL, Y_ALL, None))
    src = TB.prepare_loocv_sources(cfg, unweighted, IDX)
    assert src.total.shape == (K, K + M) and src.xw.shape == (N, K)
    assert src.xw is src.xu and src.yw is src.yu
    assert src.gx.shape == (2, K) and src.gy.shape == (2, M)
    assert src.scal.shape == (len(IDX), 3)
    assert_allclose(src.scal[:, 0].numpy(), N - 1)
    weighted = port_state(J.fit(J.CVConfig(), X_ALL, Y_ALL, W_ALL))
    src = TB.prepare_loocv_sources(cfg, weighted, IDX)
    assert src.xw is not src.xu and src.yw is not src.yu
    # divisor = (nnz_t - ddof) * sw_t / nnz_t in floating point
    nnz_t = np.count_nonzero(W_ALL) - (W_ALL[IDX] != 0)
    sw_t = W_ALL.sum() - W_ALL[IDX]
    assert_allclose(src.scal[:, 2].numpy(), nnz_t / ((nnz_t - 1) * sw_t),
                    rtol=1e-14)


def test_single_tile_gate_matches_jax():
    for k, m in ((9, 4), (120, 8), (120, 9), (500, 10), (1000, 24),
                 (1000, 25), (1100, 0)):
        x = np.zeros((3, k))
        y = np.zeros((3, m)) if m else None
        js = J.fit(J.CVConfig(False, False, False, False), x, y)
        st = port_state(js)
        for xtx, xty in ((True, m > 0), (False, m > 0), (True, False)):
            assert (TB.loocv_single_tile_ok(T.CVConfig(), st, xtx, xty)
                    == JB.loocv_single_tile_ok(J.CVConfig(), js, xtx, xty))


def test_impl_cuda_on_cpu_raises():
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        twin((True,) * 4, True, True, impl="cuda")
    with pytest.raises(ValueError, match="Unknown impl"):
        twin((True,) * 4, True, True, impl="pallas")


def test_unported_routes_raise_naming_kernel():
    """Every route is ported: the multi-row and masked LOOCV sources that
    once raised now give the per-fold engine's matrices through the port of
    ``fused_smallfold_df64``; the gates name each route's TPU kernel."""
    cfg = T.CVConfig()
    st = port_state(J.fit(J.CVConfig(), X_ALL, Y_ALL, W_ALL))
    mask = np.ones((len(IDX), 1))
    mask[1] = 0.0
    for idx, m in ((IDX.reshape(3, 2), None), (IDX[:, None], mask)):
        src = TB.prepare_loocv_sources(cfg, st, idx, m)
        got = TB.smallfold_from_sources(cfg, src, idx, n_l=idx.shape[1],
                                        return_XTY=True,
                                        has_mask=m is not None)
        (xtx, xty), _ = T.training_matrices(cfg, st, idx, m)
        assert_allclose(got[:, :, :K].numpy(), xtx.numpy(), atol=1e-8,
                        rtol=0)
        assert_allclose(got[:, :, K:].numpy(), xty.numpy(), atol=1e-8,
                        rtol=0)

    def kernel(n_l, masked=False):
        return TB.TPU_KERNELS[TB.route_kernel(T.CVConfig(), st, n_l, True,
                                              True, masked)]

    assert kernel(1).startswith("fused_loocv_df64")
    assert kernel(1, masked=True).startswith("fused_downdate_df64_packed")
    assert kernel(100).startswith("fused_ozaki_downdate_v3")
    assert kernel(1000).startswith("fused_ozaki_downdate_df64")
    assert kernel(5000).startswith("fused_epilogue_df64")
    # float32 batches route to the f32 engine's kernels, LOOCV included
    cfg32 = T.CVConfig(dtype=np.float32)

    def kernel32(n_l, masked=False):
        return TB.TPU_KERNELS[TB.route_kernel(cfg32, st, n_l, True, True,
                                              masked)]

    assert "fused_loocv_f32 " in kernel32(1)
    assert kernel32(4).startswith("fused_downdate_f32_packed")
    assert kernel32(1, masked=True).startswith("fused_downdate_f32_packed")
    assert kernel32(100, masked=True).startswith("fused_downdate (")


def test_rows_out_of_range_rejected_before_launch():
    st = port_state(J.fit(J.CVConfig(), X_ALL, Y_ALL, W_ALL))
    for bad in ([0, N], [-1, 2]):
        with pytest.raises(ValueError, match=r"outside \[0, 70\)"):
            TB.prepare_loocv_sources(T.CVConfig(), st, np.array(bad))
    src = TB.prepare_loocv_sources(T.CVConfig(), st, IDX)
    with pytest.raises(ValueError, match="outside"):
        TB.loocv_from_sources(T.CVConfig(), src, np.array([N] * len(IDX)),
                              return_XTY=True)


def test_out_buffer_and_launch_count_on_cpu():
    """On CPU tensors the wrapper runs the twin; it writes ``out`` and
    counts no kernel launch."""
    st = port_state(J.fit(J.CVConfig(), X_ALL, Y_ALL, W_ALL))
    cfg = T.CVConfig()
    src = TB.prepare_loocv_sources(cfg, st, IDX)
    before = TL.fused_loocv.launches
    buf = torch.empty((len(IDX), K, K + M), dtype=torch.float64)
    got = TB.loocv_from_sources(cfg, src, IDX, return_XTY=True, out=buf)
    assert got is buf
    assert TL.fused_loocv.launches == before
    ref = TL.loocv_reference(
        src, torch.as_tensor(IDX), src.scal, center_xtx=True, center_xty=True,
        scale_x=True, scale_y=True, with_y=True, resolution=cfg.resolution)
    assert torch.equal(buf, ref)


# ---- the symmetric kernel's twin (fused_loocv_df64_sym) ------------------ #

NS, KS, MS = 300, 130, 3  # kp = cp = 256: two 128-tiles a side in JAX
_rs = np.random.default_rng(5)
XS = _rs.normal(size=(NS, KS)) * 2 + 0.5
YS = _rs.normal(size=(NS, MS))
WS = _rs.uniform(0, 2, size=NS)
IDX_S = np.array([0, 5, 77, 299])
SYM_FLAGS = [(True,) * 4, (False,) * 4, (True, True, False, False),
             (False, False, True, True)]


def _sym_both(flags, weighted):
    """The port's symmetric twin and the JAX sym kernel's arguments."""
    w = WS if weighted else None
    jcfg = J.CVConfig(*flags)
    js = J.fit(jcfg, XS, YS, w)
    cfg = T.CVConfig(*flags)
    st = port_state(js)
    src = TB.prepare_loocv_sources(cfg, st, IDX_S)
    out = TB.loocv_from_sources(cfg, src, IDX_S, return_XTY=True, sym=True)
    full = TB.loocv_from_sources(cfg, src, IDX_S, return_XTY=True)
    jsrc = JB.prepare_loocv_sources(jcfg, js, IDX_S[:, None])
    args = (IDX_S.astype(np.int32), jsrc.total4, jsrc.xw, jsrc.xu, jsrc.yu,
            jsrc.yw, jsrc.gx, jsrc.gy, jsrc.ymask, jsrc.scal)
    kw = dict(center_xtx=jcfg.center_X,
              center_xty=jcfg.center_X or jcfg.center_Y,
              scale_x=jcfg.scale_X, scale_y=jcfg.scale_Y, with_y=True,
              resolution=jcfg.resolution)
    return out, full, args, kw


def _pairs_to_f64(pair):
    pair = np.asarray(pair)
    return (pair[:, 0].astype(np.float64)
            + pair[:, 1].astype(np.float64))[:, :KS, :KS + MS]


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("flags", SYM_FLAGS)
def test_sym_twin_matches_jax_sym_reference(flags, weighted):
    """Against ``fused_loocv_df64_sym_reference`` (bt=128), the JAX eager
    model of its sym kernel, at 1e-11 of the largest entry (the JAX
    package's own bound between its sym and full models): the JAX kernel
    mirrors whole off-diagonal tiles and computes its diagonal tiles, the
    port mirrors every entry below the diagonal, and the two differ by
    the factor form's rounding asymmetry. The port's X block is exactly
    symmetric and its upper triangle and XTY columns are the full twin's,
    bit for bit."""
    out, full, args, kw = _sym_both(flags, weighted)
    x = out[:, :, :KS]
    assert torch.equal(x, x.mT)
    iu = np.triu_indices(KS)
    assert torch.equal(out[:, iu[0], iu[1]], full[:, iu[0], iu[1]])
    assert torch.equal(out[:, :, KS:], full[:, :, KS:])
    ref = _pairs_to_f64(JK.fused_loocv_df64_sym_reference(*args, **kw,
                                                          bt=128))
    scale = np.abs(ref).max()
    assert np.abs(out.numpy() - ref).max() <= 1e-11 * scale


def test_sym_twin_matches_jax_sym_kernel_interpret():
    """Against ``fused_loocv_df64_sym`` in interpret mode, at 1e-5 of the
    largest entry: the JAX package's own bound for its sym kernel in
    interpret mode (the interpreter fuses ``a*b+c`` and breaks the
    double-float compensation)."""
    out, _, args, kw = _sym_both((True,) * 4, True)
    ref = _pairs_to_f64(JK.fused_loocv_df64_sym(*args, **kw, bt=128,
                                                interpret=True))
    scale = np.abs(ref).max()
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * scale


def test_sym_and_x2_wrappers_on_cpu():
    """On CPU tensors the sym and two-per-block entries run their twins,
    count no launch and fill ``out``; x2 is the one-per-block twin."""
    cfg = T.CVConfig()
    st = port_state(J.fit(J.CVConfig(), XS, YS, WS))
    src = TB.prepare_loocv_sources(cfg, st, IDX_S)
    before = TL.launch_counts()
    buf = torch.empty((len(IDX_S), KS, KS + MS), dtype=torch.float64)
    got = TB.loocv_from_sources(cfg, src, IDX_S, return_XTY=True, sym=True,
                                out=buf)
    assert got is buf
    assert torch.equal(buf, TL.loocv_sym_reference(
        src, torch.as_tensor(IDX_S), src.scal, **TB._loocv_flags(cfg, True)))
    two = TB.loocv_from_sources(cfg, src, IDX_S, return_XTY=True,
                                two_per_step=True)
    one = TB.loocv_from_sources(cfg, src, IDX_S, return_XTY=True)
    assert torch.equal(one, two)
    assert TL.launch_counts() == before
    with pytest.raises(ValueError, match="folds_per_block"):
        TL.fused_loocv(src, IDX_S, src.scal, folds_per_block=3,
                       **TB._loocv_flags(cfg, True))
    with pytest.raises(ValueError, match="folds_per_block"):
        TL.fused_loocv(src, IDX_S, src.scal, sym=True, folds_per_block=2,
                       **TB._loocv_flags(cfg, True))
    with pytest.raises(ValueError, match="impl='cuda'"):
        TB.loocv_from_sources(cfg, src, IDX_S, return_XTY=True, sym=True,
                              impl="cuda")


# ---- the training statistics the kernels store ---------------------------- #


def _stats_state(flags, weighted, with_y, dtype):
    cfg = T.CVConfig(*flags, dtype=dtype)
    st = T.fit(cfg, X_ALL, Y_ALL if with_y else None,
               W_ALL if weighted else None, device="cpu")
    return cfg, st


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("with_y", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("flags", list(product([False, True], repeat=4)))
def test_twin_stats_match_summed_stats(flags, weighted, with_y, dtype):
    """The statistics the twins return beside the matrices (the kernels'
    vector phase stores the same) against ``_summed_stats`` on the same
    rows, at 1e-12 relative in float64 and 1e-5 in float32, ``None`` in
    the same places; the symmetric and two-per-block twins return the same
    statistics bit for bit, and the matrices are those of a call without
    them."""
    cfg, st = _stats_state(flags, weighted, with_y, dtype)
    src = TB.prepare_loocv_sources(cfg, st, IDX, return_XTY=with_y)
    out, stats = TB.loocv_from_sources(cfg, src, IDX, return_XTY=with_y,
                                       return_stats=True)
    assert torch.equal(out, TB.loocv_from_sources(cfg, src, IDX,
                                                  return_XTY=with_y))
    ref = TB._summed_stats(cfg, st, torch.as_tensor(IDX)[:, None], None,
                           **TB._stat_flags(cfg, True, with_y))[:4]
    rtol = 1e-12 if dtype == np.float64 else 1e-5
    for got, want in zip(stats, ref):
        assert (got is None) == (want is None)
        if got is not None:
            assert got.shape == want.shape and got.dtype == want.dtype
            assert_allclose(got.numpy(), want.numpy(), rtol=rtol, atol=0)
    others = [dict(two_per_step=True)]
    if dtype == np.float64:
        others.append(dict(sym=True))
    for kw in others:
        _, again = TB.loocv_from_sources(cfg, src, IDX, return_XTY=with_y,
                                         return_stats=True, **kw)
        for a, b in zip(stats, again):
            assert (a is None and b is None) or torch.equal(a, b)


def _oracle_stats_fn(mats, stats):
    """One fold's statistics, flattened, and one matrix entry."""
    xtx = mats[0] if isinstance(mats, tuple) else mats
    return torch.cat([s.reshape(-1) for s in stats if s is not None]
                     + [xtx[0, :1]])


@pytest.mark.parametrize("entry", ["batched", "reduce"])
@pytest.mark.parametrize("with_y", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("flags", list(product([False, True], repeat=4)))
def test_loocv_route_stats_match_oracle(flags, weighted, with_y, entry):
    """Every LOOCV fold's statistics through ``training_matrices_batched``
    (one call, the ``loocv`` route) and through ``cross_validate_reduce``'s
    hoisted LOOCV loop (chunks of 16 folds) against ``tests/oracle.py`` at
    the 1e-8 contract, where both have the statistic; ``None`` where the
    per-fold engine has ``None``."""
    cfg, st = _stats_state(flags, weighted, with_y, np.float64)
    idx = np.arange(N)[:, None]
    assert TB.route_kernel(cfg, st, 1, True, with_y, False,
                           n_folds=N) == "loocv"
    _, per_fold = T.training_matrices(cfg, st, idx[0],
                                      return_XTY=with_y)
    if entry == "batched":
        _, stats = TB.training_matrices_batched(cfg, st, idx,
                                                return_XTY=with_y)
        assert [s is None for s in stats] == [s is None for s in per_fold]
        present = [s.reshape(N, -1) for s in stats if s is not None]
        got = torch.cat(present, dim=1) if present else None
    else:
        red = TS.cross_validate_reduce(
            cfg, st, idx, reduce_fn=_oracle_stats_fn, return_XTY=with_y,
            batch_size=16)
        got = red[:, :-1] if red.shape[1] > 1 else None
    oracle = NaiveOracle(*flags).fit(X_ALL, Y_ALL if with_y else None,
                                     W_ALL if weighted else None)
    if got is None:
        assert all(s is None for s in per_fold)
        return
    for f in range(N):
        _, ref = oracle.training_matrices(
            np.delete(np.arange(N), f), return_XTX=True, return_XTY=with_y)
        mine = got[f].numpy()
        off = 0
        for p, r in zip(per_fold, ref):
            if p is None:
                continue
            width = p.shape[-1]
            if r is not None:
                assert_allclose(mine[off:off + width], r.reshape(-1),
                                atol=1e-8, rtol=0)
            off += width
        assert off == mine.size
