"""The K-fold routes of the port: operand builders and plain twins.

The JAX fitted state feeds the port through ``FitState.from_numpy``, so the
fold math is held apart from the fit. Each route's twin is held against
the JAX package's vmapped engine (``training_matrices_batched(impl="xla")``)
over 16 flags x weights x mask x Y at 1e-10 (``tests/test_batch.py``'s
bound), and against the JAX function that reaches its Pallas kernel, run
as the JAX package's own CPU tests run it: the eager model
``fused_ozaki_v3_reference`` for v3 (1e-8, ``tests/test_loocv_kernel.py``),
``training_matrices_batched(impl="pallas")`` in interpret mode for the
packed and epilogue kernels (1e-10) and the Ozaki-df64 kernel (the JAX
package's interpret bound for its Ozaki kernels, see that test). The CUDA
kernels are held
against these twins on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import dataclasses
from itertools import product

import jax.experimental.pallas as pl
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
from cvmatrix_tpu_torch.ops import fold_downdate as TFD

from .data import make_dataset, zero_fraction

X_ALL, Y_ALL, FOLDS, WEIGHTS = make_dataset(n=200, k=6, m=2)
N, K, M = X_ALL.shape[0], X_ALL.shape[1], Y_ALL.shape[1]
W_ALL = zero_fraction(WEIGHTS)

# (F, L) fold batches: 25 folds of 8 rows (packed) and 5 of 40 (the rest);
# the masked variants drop each fold's last rows.
IDX_SMALL = np.arange(N).reshape(8, 25).T.copy()
IDX_LARGE = np.arange(N).reshape(40, 5).T.copy()


def _mask(idx, drop):
    mask = np.ones(idx.shape)
    mask[:, -drop:] = 0.0
    return mask


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode (the JAX
    package's own fixture in ``tests/test_batch.py``)."""
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(JK.pl, "pallas_call", interp)


def port_state(js):
    return T.FitState.from_numpy({
        f.name: None if getattr(js, f.name) is None
        else np.asarray(getattr(js, f.name))
        for f in dataclasses.fields(js)
    })


def fit_both(flags, weighted, with_y, mode="auto", x=X_ALL, y=Y_ALL):
    jcfg = J.CVConfig(*flags, matmul_mode=mode)
    js = J.fit(jcfg, x, y if with_y else None, W_ALL if weighted else None)
    return jcfg, js, T.CVConfig(*flags, matmul_mode=mode), port_state(js)


def run_route(route, cfg, st, idx, mask, xtx, xty, impl="auto"):
    """One route's output (F, K, C), whatever route_kernel would pick."""
    if route == "packed":
        ops, _ = TB.prepare_fold_operands(cfg, st, idx, mask, return_XTX=xtx,
                                          return_XTY=xty)
        return TB.downdate_from_operands(ops, impl=impl)
    if route == "v3":
        src = TB.prepare_ozaki_sources(cfg, st, idx, mask, return_XTX=xtx,
                                       return_XTY=xty)
        return TB.ozaki_v3_from_sources(cfg, src, return_XTY=xty, impl=impl)
    rows, mk = TB._rows_mask(cfg, st, idx, mask)
    if route == "epilogue":  # the large-fold path without fusion
        cfg = dataclasses.replace(cfg, matmul_mode="native")
    assert TB._use_fused(cfg, st, xtx, xty, idx.shape[1]) == (
        route == "ozaki_df64")
    return TB._large_fold_path(cfg, st, rows, mk,
                               total=TB._total(st, xtx, xty),
                               return_XTX=xtx, return_XTY=xty,
                               impl=impl)[0]


def as_np(mats, xtx, xty):
    if xtx and xty:
        return np.concatenate([np.asarray(a) for a in mats], axis=2)
    return np.asarray(mats)


ROUTE_BATCH = {"packed": IDX_SMALL, "v3": IDX_LARGE,
               "ozaki_df64": IDX_LARGE, "epilogue": IDX_LARGE}


@pytest.mark.parametrize("flags", list(product([False, True], repeat=4)))
def test_twins_match_jax_engine(flags):
    """Every route's twin against the XLA engine: weighted and not, masked
    and not, [XTX | XTY] and XTX alone, at 1e-10."""
    for weighted, masked, with_y in product([True, False], repeat=3):
        jcfg, js, cfg, st = fit_both(flags, weighted, with_y)
        refs = {}
        for idx in (IDX_SMALL, IDX_LARGE):
            mask = _mask(idx, 3) if masked else None
            ref, _ = JB.training_matrices_batched(
                jcfg, js, idx, mask, return_XTX=True, return_XTY=with_y,
                impl="xla")
            refs[id(idx)] = (mask, as_np(ref, True, with_y))
        for route, idx in ROUTE_BATCH.items():
            mask, ref = refs[id(idx)]
            out = run_route(route, cfg, st, idx, mask, True, with_y)
            assert out.shape == (idx.shape[0], K, K + (M if with_y else 0))
            assert_allclose(out.numpy(), ref, atol=1e-10, rtol=0,
                            err_msg=f"{route} {weighted=} {masked=}")


@pytest.mark.parametrize("route", ["packed", "ozaki_df64", "epilogue"])
def test_twins_match_jax_engine_xty_only(route):
    """XTY alone (C = M): the factor and reference forms without the X
    columns."""
    for flags in [(True,) * 4, (False, True, False, True),
                  (True, False, True, False), (False,) * 4]:
        for masked in (False, True):
            jcfg, js, cfg, st = fit_both(flags, True, True)
            idx = ROUTE_BATCH[route]
            mask = _mask(idx, 2) if masked else None
            ref, _ = JB.training_matrices_batched(
                jcfg, js, idx, mask, return_XTX=False, impl="xla")
            out = run_route(route, cfg, st, idx, mask, False, True)
            assert_allclose(out.numpy(), np.asarray(ref), atol=1e-10, rtol=0)


def test_batched_engine_routes_and_stats():
    """training_matrices_batched picks the route by route_kernel and
    returns the per-fold engine's statistics."""
    flags = (True, True, True, True)
    jcfg, js, cfg, st = fit_both(flags, True, True)
    for idx, mask, route in ((IDX_SMALL[:, :1], None, "loocv"),
                             (IDX_SMALL, _mask(IDX_SMALL, 2), "packed"),
                             (IDX_LARGE, _mask(IDX_LARGE, 4), "v3")):
        assert TB.route_kernel(cfg, st, idx.shape[1], True, True,
                               mask is not None) == route
        (gx, gy), gstats = TB.training_matrices_batched(cfg, st, idx, mask)
        (rx, ry), rstats = JB.training_matrices_batched(jcfg, js, idx, mask,
                                                        impl="xla")
        assert_allclose(gx.numpy(), np.asarray(rx), atol=1e-10, rtol=0)
        assert_allclose(gy.numpy(), np.asarray(ry), atol=1e-10, rtol=0)
        for g, r in zip(gstats, rstats):
            assert_allclose(g.numpy(), np.asarray(r), atol=1e-12, rtol=0)
    # float32 runs the per-fold engine on the CPU
    st32 = T.fit(T.CVConfig(dtype=np.float32), X_ALL, Y_ALL, W_ALL,
                 device="cpu")
    (gx, _), _ = TB.training_matrices_batched(T.CVConfig(dtype=np.float32),
                                              st32, IDX_LARGE)
    assert gx.dtype == torch.float32


@pytest.mark.parametrize("flags", [(True,) * 4, (False,) * 4,
                                   (True, False, False, True),
                                   (False, True, True, False)])
def test_packed_twin_matches_jax_kernel(interpret_pallas, flags):
    """Against fused_downdate_df64_packed in interpret mode (folds of 8)."""
    for masked in (False, True):
        jcfg, js, cfg, st = fit_both(flags, True, True)
        mask = _mask(IDX_SMALL, 2) if masked else None
        assert JB.large_fold_threshold(jcfg, js, True, True) > 8
        ref, _ = JB.training_matrices_batched(jcfg, js, IDX_SMALL, mask,
                                              impl="pallas")
        out = run_route("packed", cfg, st, IDX_SMALL, mask, True, True)
        assert_allclose(out.numpy(), as_np(ref, True, True), atol=1e-10,
                        rtol=0)


def test_ozaki_df64_twin_matches_jax_kernel(interpret_pallas):
    """Against fused_ozaki_downdate_df64 in interpret mode: the JAX large-
    fold path fuses in exact mode (its "auto" fuses on the TPU only).

    Bound 1e-5 of the largest entry, the JAX package's own bound for its
    Ozaki kernels in interpret mode (``test_ozaki_v3_interpret_wiring``),
    not 1e-10: the interpreter fuses ``a*b+c`` and so breaks the kernel's
    double-float compensation; the JAX kernel's interpret run is itself up
    to 3.1e-5 (an f32 ulp of its entries) away from the JAX XLA engine
    here. The twin meets 1e-10 against that engine
    (``test_twins_match_jax_engine``)."""
    jcfg, js, cfg, st = fit_both((True,) * 4, True, True, mode="exact")
    _, idx, mask = J.Partitioner(FOLDS).padded_batches()
    ref, _ = JB.training_matrices_batched(jcfg, js, idx, mask, impl="pallas")
    ref = as_np(ref, True, True)
    out = run_route("ozaki_df64", cfg, st, idx, mask, True, True)
    assert_allclose(out.numpy(), ref, atol=1e-5 * max(np.abs(ref).max(), 1.0),
                    rtol=0)


def test_epilogue_twin_matches_jax_kernel(interpret_pallas):
    """Against fused_epilogue_df64 in interpret mode: a Y of 130 columns
    makes Kp != Cp, so neither package fuses (the product is a GEMM)."""
    rng = np.random.default_rng(5)
    y_wide = rng.random((N, 130))
    jcfg, js, cfg, st = fit_both((True,) * 4, True, True, x=X_ALL,
                                 y=y_wide)
    _, idx, mask = J.Partitioner(FOLDS).padded_batches()
    assert TB.route_kernel(cfg, st, idx.shape[1], True, True,
                           True) == "epilogue"
    ref, _ = JB.training_matrices_batched(jcfg, js, idx, mask, impl="pallas")
    (gx, gy), _ = TB.training_matrices_batched(cfg, st, idx, mask)
    assert_allclose(gx.numpy(), np.asarray(ref[0]), atol=1e-10, rtol=0)
    assert_allclose(gy.numpy(), np.asarray(ref[1]), atol=1e-10, rtol=0)


@pytest.mark.parametrize("xty", [True, False])
def test_epilogue_twin_matches_jax_kernel_odd_c_and_xtx_alone(
        interpret_pallas, monkeypatch, xty):
    """Against fused_epilogue_df64 in interpret mode at the wide-K
    configuration's widths: C = K + 1 (M = 1, odd) and C = K (XTX alone).
    In "native" mode neither package takes v3 or fuses, so both reach the
    epilogue kernel, which the JAX path is seen to call."""
    calls = []
    orig = JK.fused_epilogue_df64

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(JK, "fused_epilogue_df64", counted)
    jcfg, js, cfg, st = fit_both((True,) * 4, True, True, mode="native",
                                 y=Y_ALL[:, :1])
    _, idx, mask = J.Partitioner(FOLDS).padded_batches()
    assert TB.route_kernel(cfg, st, idx.shape[1], True, xty,
                           True) == "epilogue"
    ref, _ = JB.training_matrices_batched(jcfg, js, idx, mask,
                                          return_XTY=xty, impl="pallas")
    assert calls
    got, _ = TB.training_matrices_batched(cfg, st, idx, mask, return_XTY=xty)
    got = as_np(got, True, xty)
    assert got.shape[2] == K + (1 if xty else 0)
    assert_allclose(got, as_np(ref, True, xty), atol=1e-10, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_wide_k_epilogue_route_matches_jax_engine(masked):
    """K = 520 (padded 640 > 512) with M = 1, as the wide-K configuration
    (K = 20,000, M = 1) routes: no v3, no fusion, so a ``bmm`` and the
    epilogue; against the JAX XLA engine at 1e-10, [XTX | XTY] and XTX
    alone."""
    rng = np.random.default_rng(9)
    n, k = 600, 520
    x, y, w = rng.random((n, k)), rng.random((n, 1)), rng.random(n)
    jcfg = J.CVConfig(True, True, True, True, ddof=1)
    js = J.fit(jcfg, x, y, w)
    cfg, st = T.CVConfig(True, True, True, True, ddof=1), port_state(js)
    idx = np.arange(n).reshape(5, 120)
    mask = _mask(idx, 7) if masked else None
    for xty in (True, False):
        assert TB.route_kernel(cfg, st, 120, True, xty, masked) == "epilogue"
        ref, _ = JB.training_matrices_batched(jcfg, js, idx, mask,
                                              return_XTY=xty, impl="xla")
        got, _ = TB.training_matrices_batched(cfg, st, idx, mask,
                                              return_XTY=xty)
        assert_allclose(as_np(got, True, xty), as_np(ref, True, xty),
                        atol=1e-10, rtol=0)


@pytest.mark.parametrize("flags", [(True,) * 4, (False,) * 4,
                                   (True, False, False, True),
                                   (False, True, True, False)])
def test_v3_twin_matches_jax_kernel_model(flags):
    """Against fused_ozaki_v3_reference, the JAX package's eager model of
    its v3 kernel (int8 slices, double-float pairs), at 1e-8."""
    for masked, with_y in product([False, True], repeat=2):
        jcfg, js, cfg, st = fit_both(flags, True, with_y)
        mask = _mask(IDX_LARGE, 5) if masked else None
        src = JB.prepare_ozaki_sources(jcfg, js, IDX_LARGE, mask,
                                       return_XTY=with_y)
        pair = JK.fused_ozaki_v3_reference(
            np.asarray(src.idx),
            None if src.mask2d is None else np.asarray(src.mask2d),
            src.total2, src.saN, src.sbN_rev, src.pa, src.pb, src.gx,
            src.sxv, src.yvec, src.ymask, src.scal,
            center_xtx=jcfg.center_X,
            center_xty=jcfg.center_X or jcfg.center_Y,
            scale_x=jcfg.scale_X, scale_y=jcfg.scale_Y, with_y=with_y,
            resolution=jcfg.resolution,
        )
        c = K + (M if with_y else 0)
        ref = np.asarray(df_to_f64(pair[:, 0], pair[:, 1]))[:, :K, :c]
        out = run_route("v3", cfg, st, IDX_LARGE, mask, True, with_y)
        assert_allclose(out.numpy(), ref, atol=1e-8, rtol=0)


@pytest.mark.parametrize("flags", list(product([False, True], repeat=4)))
def test_summed_stats_match_gathered_blocks(flags):
    """The statistics of the routes whose kernels gather the rows
    themselves (one gather of the unweighted rows, batched mat-vecs)
    against those of the gathered blocks, weighted and not, masked and
    not, with Y and XTX alone."""
    for weighted, masked, with_y in product([True, False], repeat=3):
        _, _, cfg, st = fit_both(flags, weighted, with_y)
        mask = _mask(IDX_LARGE, 3) if masked else None
        rows, mk = TB._rows_mask(cfg, st, IDX_LARGE, mask)
        sides = dict(return_XTX=True, return_XTY=with_y)
        _, ref = TB._gather_and_stats(cfg, st, rows, mk, *sides.values())
        got = TB._summed_stats(cfg, st, rows, mk,
                               **TB._stat_flags(cfg, *sides.values()))
        for g, r in zip(got, ref):
            assert (g is None) == (r is None)
            if r is not None:
                assert g.shape == r.shape
                assert_allclose(g.numpy(), r.numpy(), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("weighted,masked", [(True, True), (False, False),
                                             (False, True)])
def test_operand_builders_match_jax(weighted, masked):
    """prepare_fold_operands (unpaired) and prepare_ozaki_sources' sxv,
    yvec and scal against the JAX builders' f64 values."""
    flags = (True, True, True, True)
    jcfg, js, cfg, st = fit_both(flags, weighted, True)
    mask = _mask(IDX_SMALL, 2) if masked else None
    jops, _ = JB.prepare_fold_operands(jcfg, js, IDX_SMALL, mask)
    ops, _ = TB.prepare_fold_operands(cfg, st, IDX_SMALL, mask)

    def unpair(a, axis_pair, width):
        hi = np.take(np.asarray(a), 0, axis=axis_pair)
        lo = np.take(np.asarray(a), 1, axis=axis_pair)
        return np.asarray(df_to_f64(hi, lo))[..., :width]

    c = K + M
    for name, got, ref in (
            ("u", ops.u, unpair(jops.u, 2, K)),
            ("v", ops.v, unpair(jops.v, 2, c)),
            ("kvec", ops.kvec, unpair(jops.kvec, 2, K)),
            ("cvec", ops.cvec, unpair(jops.cvec, 2, c))):
        assert_allclose(got.numpy(), ref, rtol=1e-14, atol=1e-13,
                        err_msg=name)
    mask = _mask(IDX_LARGE, 4) if masked else None
    jsrc = JB.prepare_ozaki_sources(jcfg, js, IDX_LARGE, mask)
    src = TB.prepare_ozaki_sources(cfg, st, IDX_LARGE, mask)
    assert_allclose(src.sxv.numpy(), unpair(jsrc.sxv, 1, K), rtol=1e-14,
                    atol=1e-13)
    assert_allclose(src.yvec.numpy(), unpair(jsrc.yvec, 2, c), rtol=1e-14,
                    atol=1e-13)
    jscal = np.asarray(jsrc.scal)[:, 0, :6].astype(np.float64)
    assert_allclose(src.scal.numpy(), jscal[:, 0::2] + jscal[:, 1::2],
                    rtol=1e-13)


def test_cpu_wrappers_run_twins_and_count_nothing():
    """On CPU tensors the wrappers run the twins and launch nothing; out
    buffers are written; the epilogue rewrites its product in place."""
    jcfg, js, cfg, st = fit_both((True,) * 4, True, True)
    before = TFD.launch_counts()
    ops, _ = TB.prepare_fold_operands(cfg, st, IDX_SMALL)
    buf = torch.empty((IDX_SMALL.shape[0], K, K + M), dtype=torch.float64)
    got = TB.downdate_from_operands(ops, out=buf)
    assert got is buf
    assert torch.equal(buf, TFD.packed_reference(*ops))
    prod = torch.ones((2, K, K + M), dtype=torch.float64)
    kvec = torch.ones((2, 2, K), dtype=torch.float64)
    cvec = torch.ones((2, 2, K + M), dtype=torch.float64)
    res = TFD.fold_epilogue(ops.total, prod, kvec, cvec)
    assert res is prod
    assert torch.equal(prod, (ops.total - 2.0).expand(2, K, K + M))
    assert TFD.launch_counts() == before


def test_wrapper_argument_errors():
    _, _, cfg, st = fit_both((True,) * 4, True, True)
    ops, _ = TB.prepare_fold_operands(cfg, st, IDX_SMALL)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        TB.downdate_from_operands(ops, impl="cuda")
    with pytest.raises(ValueError, match="Unknown impl"):
        TB.downdate_from_operands(ops, impl="pallas")
    for bad in (np.array([[0, N]]), np.array([[-1, 2]])):
        with pytest.raises(ValueError, match=r"outside \[0, 200\)"):
            TB.prepare_ozaki_sources(cfg, st, bad)
    # the batched engine wraps [-N, 0) as NumPy does; beyond it raises
    for bad in (np.array([[0, N]]), np.array([[-N - 1, 2]])):
        with pytest.raises(ValueError, match=r"outside \[-200, 200\)"):
            TB.training_matrices_batched(cfg, st, bad)
    with pytest.raises(ValueError, match="return_XTX"):
        TB.prepare_ozaki_sources(cfg, st, IDX_LARGE, return_XTX=False)
    with pytest.raises(ValueError, match="At least one"):
        TB.training_matrices_batched(cfg, st, IDX_LARGE, return_XTX=False,
                                     return_XTY=False)
    with pytest.raises(ValueError, match="Unknown impl"):
        TB.training_matrices_batched(cfg, st, IDX_LARGE, impl="xla")


# ---- the float32 stream tile's split rule (fold_downdate_f32) ----------- #


def _busiest_sm_rows(f, k, c, n_l, n_sm, s):
    tiles = f * -(-k // 128) * -(-c // 128)
    return -(-tiles * s // n_sm) * -(-n_l // s)


@pytest.mark.parametrize("f,k,c,n_l,n_sm,expect", [
    (3, 500, 510, 33_334, 132, 8),    # P=3 at K=500, M=10
    (2, 500, 510, 33_334, 132, 4),    # ties go to the smaller split
    (1, 500, 510, 33_334, 132, 8),
    (500, 500, 510, 100, 132, 1),     # P=1,000: many folds
    (33, 500, 510, 33_334, 132, 1),   # 528 tiles: two waves of 132 SMs
    (32, 500, 510, 33_334, 132, 1),   # 512 tiles: no split does better
    (20, 500, 510, 33_334, 132, 7),
    (1, 500, 510, 100, 132, 1),       # rows too few to split
    (1, 500, 510, 1_100, 132, 2),     # 550 rows a split at S=2, not at 3
    (3, 500, 510, 33_334, 114, 7),    # another SM count, another split
    (1, 37, 43, 5_000, 132, 8),
])
def test_downdate_f32_splits_rule(f, k, c, n_l, n_sm, expect):
    """The split count is a function of (F, K, C, L, SMs): none from two
    waves of 128 x 128 tiles up (2 blocks an SM), else the S in 1 .. 8
    with at least 512 rows a split that minimises the rows the busiest SM
    multiplies, the smallest on ties."""
    got = TFD.downdate_f32_splits(f, k, c, n_l, n_sm)
    assert got == expect
    tiles = f * -(-k // 128) * -(-c // 128)
    if tiles >= 4 * n_sm:
        assert got == 1
        return
    allowed = [s for s in range(1, 9) if s == 1 or -(-n_l // s) >= 512]
    costs = {s: _busiest_sm_rows(f, k, c, n_l, n_sm, s) for s in allowed}
    assert got == min(allowed, key=lambda s: (costs[s], s))


def test_downdate_f32_cpu_wrapper_runs_the_twin():
    """On CPU tensors fold_downdate_f32 runs its twin (no split, no card
    query) and counts no launch, writing ``out`` where given."""
    rng = np.random.default_rng(23)
    ops = [torch.from_numpy(rng.random(s, dtype=np.float32))
           for s in ((6, 9), (2, 40, 6), (2, 40, 9), (2, 2, 6), (2, 2, 9))]
    before = TFD.launch_counts()
    buf = torch.empty((2, 6, 9))
    got = TFD.fold_downdate_f32(*ops, out=buf)
    assert got is buf and TFD.launch_counts() == before
    assert torch.equal(buf, TFD.downdate_f32_reference(*ops))


# ---- the symmetric v3 kernel's twin (fused_ozaki_downdate_v3_sym) -------- #

NS, KS, MS = 300, 130, 3  # kp = cp = 256: two 128-tiles a side in JAX
_rs = np.random.default_rng(9)
XS = _rs.normal(size=(NS, KS)) * 2 + 0.5
YS = _rs.normal(size=(NS, MS))
WS = _rs.uniform(0, 2, size=NS)
IDX_V3S = np.arange(80).reshape(2, 40)


@pytest.fixture
def sym_on():
    """``sym_loocv`` on in both packages, restored afterwards."""
    before = J.policy(), T.policy()
    J.set_routing(sym_loocv=True)
    T.set_routing(sym_loocv=True)
    yield
    J.set_routing(**dataclasses.asdict(before[0]))
    T.set_routing(**dataclasses.asdict(before[1]))


def _v3_sym_both(flags, weighted, masked):
    jcfg = J.CVConfig(*flags)
    js = J.fit(jcfg, XS, YS, WS if weighted else None)
    cfg, st = T.CVConfig(*flags), port_state(js)
    mask = _mask(IDX_V3S, 6) if masked else None
    assert TB.route_kernel(cfg, st, 40, True, True, masked) == "v3_sym"
    src = TB.prepare_ozaki_sources(cfg, st, IDX_V3S, mask)
    out = TB.ozaki_v3_from_sources(cfg, src, return_XTY=True)
    jsrc = JB.prepare_ozaki_sources(jcfg, js, IDX_V3S, mask)
    kw = dict(center_xtx=jcfg.center_X,
              center_xty=jcfg.center_X or jcfg.center_Y,
              scale_x=jcfg.scale_X, scale_y=jcfg.scale_Y, with_y=True,
              resolution=jcfg.resolution)
    return out, jsrc, kw


def _trim(pair):
    pair = np.asarray(pair)
    return (pair[:, 0].astype(np.float64)
            + pair[:, 1].astype(np.float64))[:, :KS, :KS + MS]


@pytest.mark.parametrize("flags", [(True,) * 4, (False,) * 4,
                                   (True, False, False, True),
                                   (False, True, True, False)])
def test_v3_sym_twin_matches_jax_kernel_model(sym_on, flags):
    """Against ``fused_ozaki_v3_sym_reference`` (bt=128), the JAX eager
    model of its sym kernel, at 1e-8 (the bound of the v3 model test
    above), weighted and masked, and unweighted; the X block exactly
    symmetric."""
    for weighted, masked in ((True, True), (False, False)):
        out, jsrc, kw = _v3_sym_both(flags, weighted, masked)
        x = out[:, :, :KS]
        assert torch.equal(x, x.mT)
        ref = _trim(JK.fused_ozaki_v3_sym_reference(
            np.asarray(jsrc.idx),
            None if jsrc.mask2d is None else np.asarray(jsrc.mask2d),
            jsrc.total2, jsrc.saN, jsrc.sbN_rev, jsrc.pa, jsrc.pb, jsrc.gx,
            jsrc.sxv, jsrc.yvec, jsrc.ymask, jsrc.scal, **kw, bt=128))
        assert_allclose(out.numpy(), ref, atol=1e-8, rtol=0)


def test_v3_sym_twin_matches_jax_kernel_interpret(sym_on):
    """Against ``fused_ozaki_downdate_v3_sym`` in interpret mode, reached
    through the JAX ``ozaki_v3_from_sources`` under its ``sym_loocv``, at
    1e-5 of the largest entry (the JAX package's interpret bound for its
    Ozaki kernels, see ``test_ozaki_df64_twin_matches_jax_kernel``)."""
    out, jsrc, kw = _v3_sym_both((True,) * 4, True, True)
    jcfg = J.CVConfig(True, True, True, True)
    ref = _trim(JB.ozaki_v3_from_sources(jcfg, jsrc, return_XTY=True,
                                         interpret=True))
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_v3_sym_twin_is_the_v3_twin_mirrored(sym_on):
    """The computed entries are the full v3 twin's, bit for bit, and the
    CPU wrapper counts no launch."""
    cfg, st = T.CVConfig(), port_state(J.fit(J.CVConfig(), XS, YS, WS))
    src = TB.prepare_ozaki_sources(cfg, st, IDX_V3S)
    before = TFD.launch_counts()
    sym = TB.ozaki_v3_from_sources(cfg, src, return_XTY=True)
    T.set_routing(sym_loocv=False)
    full = TB.ozaki_v3_from_sources(cfg, src, return_XTY=True)
    assert TFD.launch_counts() == before
    iu = np.triu_indices(KS)
    assert torch.equal(sym[:, iu[0], iu[1]], full[:, iu[0], iu[1]])
    assert torch.equal(sym[:, :, KS:], full[:, :, KS:])
    assert not torch.equal(sym, full)


# ---- the packed route at the row-stream tile's edges --------------------- #

_re = np.random.default_rng(31)
# (F, L) folds of seeded rows: 22 of 9 (under the fused gate's 10) and 6 of
# 31 (under 32, for XTY alone); ragged folds of np.arange(N) % 23 (16 of 9
# rows, 7 of 8) padded to 9 with a mask.
IDX_L9 = np.stack([_re.choice(N, 9, replace=False) for _ in range(22)])
IDX_L31 = np.stack([_re.choice(N, 31, replace=False) for _ in range(6)])
_, IDX_RAGGED, MASK_RAGGED = J.Partitioner(np.arange(N) % 23).padded_batches()
PACKED_EDGES = {
    "L=9, [XTX | XTY]": (IDX_L9, None, True),
    "L=31, XTY alone": (IDX_L31, None, False),
    "ragged L=9, masked": (IDX_RAGGED, MASK_RAGGED, True),
}


@pytest.mark.parametrize("case", list(PACKED_EDGES))
@pytest.mark.parametrize("flags", [(True,) * 4, (False,) * 4,
                                   (True, False, False, True),
                                   (False, True, True, False)])
def test_packed_route_at_tile_edges_matches_jax(flags, case):
    """The packed route (the row-stream tile's float64 entry) at the fold
    sizes its gates give it, through training_matrices_batched, against
    the JAX XLA engine on the same seeded data and folds at 1e-10
    (``test_twins_match_jax_engine``'s bound): L=9 where the fused Ozaki
    gate leaves the packed route at 10, L=31 with XTY alone (gate 32), and
    ragged masked folds; weighted and not."""
    idx, mask, xtx = PACKED_EDGES[case]
    assert idx.shape[1] in (9, 31) and (mask is None or (mask == 0).any())
    for weighted in (True, False):
        jcfg, js, cfg, st = fit_both(flags, weighted, True)
        assert TB.route_kernel(cfg, st, idx.shape[1], xtx, True,
                               mask is not None) == "packed"
        ref, _ = JB.training_matrices_batched(
            jcfg, js, idx, mask, return_XTX=xtx, impl="xla")
        got, _ = TB.training_matrices_batched(cfg, st, idx, mask,
                                              return_XTX=xtx)
        assert_allclose(as_np(got, xtx, True), as_np(ref, xtx, True),
                        atol=1e-10, rtol=0, err_msg=f"{case} {weighted=}")
