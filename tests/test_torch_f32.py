"""The float32 engine of the port: routes, plain twins and the TF32 repair.

Float32 fold batches take the JAX f32 engine's kernels: one-row folds the
LOOCV kernel (``fused_loocv_f32``), folds under ``LARGE_FOLD_ROWS`` the
packed one (``fused_downdate_f32_packed``), larger folds ``fused_downdate``.
The JAX float32 state feeds the port through ``FitState.from_numpy``, so
the fold math is held apart from the fit. Each twin is held

- against the JAX function that reaches its Pallas kernel, run in
  interpret mode as the JAX package's own tests run it
  (``tests/test_loocv_kernel.py``, ``tests/test_batch.py``);
- against the JAX XLA f32 engine (``training_matrices_batched(impl=
  "xla")``) over 16 flag sets x weights x mask x sides;

at 1e-4 of the largest reference entry, the JAX package's own float32
interpret bound: sums in float32 come out in another order in each
engine. A few cases are held against ``tests/oracle.py`` (float64, on the
float32 data) at 1e-3 of its largest entry, the JAX package's "float32
grade" (``tests/test_fuzz.py``), as an absolute bound: entries near zero
after centring carry the rounding of the large ones. The CUDA kernels are
held against these twins on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import dataclasses
from itertools import product

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvmatrix_tpu as J
import cvmatrix_tpu_torch as T
from cvmatrix_tpu.core import batch as JB
from cvmatrix_tpu.ops import kernels as JK
from cvmatrix_tpu_torch.core import batch as TB
from cvmatrix_tpu_torch.ops import fold_downdate as TFD
from cvmatrix_tpu_torch.ops import loocv as TL
from cvmatrix_tpu_torch.ops import precision as TP

from .data import make_dataset, zero_fraction
from .oracle import NaiveOracle

X64, Y64, FOLDS, WEIGHTS = make_dataset(n=200, k=6, m=2)
X_ALL, Y_ALL = X64.astype(np.float32), Y64.astype(np.float32)
W_ALL = zero_fraction(WEIGHTS).astype(np.float32)
N, K, M = X_ALL.shape[0], X_ALL.shape[1], Y_ALL.shape[1]
TWIN_RTOL = 1e-4
ORACLE_RTOL = 1e-3

# One fold batch per route: one-row folds, folds of 8 rows and of 40.
IDX_ONE = np.arange(0, N, 9)[:, None]
IDX_SMALL = np.arange(N).reshape(8, 25).T.copy()
IDX_LARGE = np.arange(N).reshape(40, 5).T.copy()


def _mask(idx):
    mask = np.ones(idx.shape, np.float32)
    mask[::2, -1] = 0.0
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


def fit_both(flags, weighted=True, with_y=True):
    jcfg = J.CVConfig(*flags, dtype=np.float32)
    js = J.fit(jcfg, X_ALL, Y_ALL if with_y else None,
               W_ALL if weighted else None)
    st = port_state(js)
    assert st.X.dtype == torch.float32 and st.XTX.dtype == torch.float32
    return jcfg, js, T.CVConfig(*flags, dtype=np.float32), st


def as_np(mats):
    if isinstance(mats, tuple):
        return np.concatenate([np.asarray(a) for a in mats], axis=2)
    return np.asarray(mats)


def assert_near(got, ref, rtol=TWIN_RTOL, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= rtol * scale, f"{msg}: max|diff| {err:.3e} > {rtol:g} * " \
                                f"{scale:.3e}"


@pytest.mark.parametrize("flags", [(True,) * 4, (False,) * 4,
                                   (True, False, False, True)])
def test_loocv_twin_matches_jax_f32_kernel(flags):
    """Against fused_loocv_f32 in interpret mode (trimmed to (K, C)), as
    ``test_f32_loocv_kernel_interpret`` runs it."""
    jcfg, js, cfg, st = fit_both(flags)
    jsrc = JB.prepare_loocv_sources(jcfg, js, IDX_ONE, presplit=False)
    ref = JB.loocv_f32_from_sources(
        jcfg, jsrc, jnp.asarray(IDX_ONE[:, 0], jnp.int32), return_XTY=True,
        interpret=True)
    ref = np.asarray(ref)[:, :K, :K + M]
    src = TB.prepare_loocv_sources(cfg, st, IDX_ONE)
    assert src.scal.dtype == torch.float32
    got = TB.loocv_from_sources(cfg, src, IDX_ONE[:, 0], return_XTY=True)
    assert got.dtype == torch.float32
    assert_near(got, ref, msg=str(flags))


@pytest.mark.parametrize("flags", [(True,) * 4, (False, True, False, True),
                                   (False,) * 4])
def test_packed_twin_matches_jax_f32_kernel(interpret_pallas, flags):
    """Against fused_downdate_f32_packed in interpret mode, on folds of 8
    rows, unmasked and masked (``test_f32_packed_small_folds``)."""
    jcfg, js, cfg, st = fit_both(flags)
    for mask in (None, _mask(IDX_SMALL)):
        assert TB.route_kernel(cfg, st, 8, True, True,
                               mask is not None) == "packed_f32"
        ref, rs = JB.training_matrices_batched(jcfg, js, IDX_SMALL, mask,
                                               impl="pallas")
        got, gs = TB.training_matrices_batched(cfg, st, IDX_SMALL, mask)
        assert_near(as_np(got), as_np(ref), msg=f"{flags} {mask is None}")


@pytest.mark.parametrize("flags", [(True,) * 4, (False, True, True, False),
                                   (False,) * 4])
def test_downdate_twin_matches_jax_f32_kernel(interpret_pallas, flags):
    """Against fused_downdate in interpret mode, on the three unequal
    masked folds of ``FOLDS`` (``test_f32_batch_kernel``)."""
    jcfg, js, cfg, st = fit_both(flags)
    _, idx, mask = J.Partitioner(FOLDS).padded_batches()
    assert TB.route_kernel(cfg, st, idx.shape[1], True, True,
                           True) == "downdate_f32"
    for xtx, xty in ((True, True), (False, True)):
        ref, _ = JB.training_matrices_batched(
            jcfg, js, idx, mask, return_XTX=xtx, return_XTY=xty,
            impl="pallas")
        got, _ = TB.training_matrices_batched(cfg, st, idx, mask,
                                              return_XTX=xtx, return_XTY=xty)
        assert_near(as_np(got), as_np(ref), msg=f"{flags} {xtx}")


@pytest.mark.parametrize("flags", list(product([False, True], repeat=4)))
def test_twins_match_jax_f32_engine(flags):
    """Every f32 route's twin against the XLA f32 engine: weighted and
    not, masked and not, [XTX | XTY], XTX alone and XTY alone, with the
    statistics. XTX alone and XTY alone are held against the matching
    columns of the engine's [XTX | XTY]."""
    for weighted, masked in product([True, False], repeat=2):
        jcfg, js, cfg, st = fit_both(flags, weighted)
        for idx, routes in ((IDX_ONE, ("loocv", "packed_f32")),
                            (IDX_SMALL, ("packed_f32",)),
                            (IDX_LARGE, ("downdate_f32",))):
            mask = _mask(idx) if masked else None
            (rx, ry), rstats = JB.training_matrices_batched(
                jcfg, js, idx, mask, impl="xla")
            ref = as_np((rx, ry))
            for xtx, xty, cols in ((True, True, slice(None)),
                                   (True, False, slice(0, K)),
                                   (False, True, slice(K, None))):
                route = TB.route_kernel(cfg, st, idx.shape[1], xtx, xty,
                                        masked)
                assert route == routes[0 if xtx and not masked else -1]
                got, gstats = TB.training_matrices_batched(
                    cfg, st, idx, mask, return_XTX=xtx, return_XTY=xty)
                got = as_np(got)
                assert got.dtype == np.float32
                assert_near(got, ref[:, :, cols],
                            msg=f"{route} {weighted=} {masked=} {xtx=}")
                if xtx and xty:
                    for g, r in zip(gstats, rstats):
                        assert (g is None) == (r is None)
                        if r is not None:
                            assert_near(g, np.asarray(r), msg="stats")


@pytest.mark.parametrize("flags", [(True,) * 4, (True, False, True, False)])
def test_routes_match_oracle(flags):
    """Each f32 route against the float64 oracle on the same float32 data,
    at 1e-3 of the oracle's largest entry."""
    _, _, cfg, st = fit_both(flags)
    oracle = NaiveOracle(*flags).fit(X_ALL.astype(np.float64),
                                     Y_ALL.astype(np.float64),
                                     W_ALL.astype(np.float64))
    _, idx_folds, mask_folds = J.Partitioner(FOLDS).padded_batches()
    for idx, mask in ((IDX_ONE[:4], None), (IDX_SMALL[:4], None),
                      (IDX_SMALL[:4], _mask(IDX_SMALL[:4])),
                      (idx_folds, mask_folds)):
        got = as_np(TB.training_matrices_batched(cfg, st, idx, mask)[0])
        for f in range(idx.shape[0]):
            val = idx[f] if mask is None else idx[f][mask[f] > 0]
            (xtx, xty), _ = oracle.training_XTX_XTY(
                np.delete(np.arange(N), val))
            ref = np.concatenate([xtx, xty], axis=1)
            assert_near(got[f], ref, ORACLE_RTOL, msg=f"{idx.shape} {f}")


def test_cpu_wrappers_run_twins_and_count_nothing():
    """On CPU tensors the float32 wrappers run their twins, write ``out``
    and count no launch; each twin keeps float32."""
    _, _, cfg, st = fit_both((True,) * 4)
    before = (TFD.launch_counts(), TL.fused_loocv.launches_f32)
    ops, _ = TB.prepare_fold_operands(cfg, st, IDX_SMALL)
    assert ops.u.dtype == ops.kvec.dtype == torch.float32
    buf = torch.empty((IDX_SMALL.shape[0], K, K + M), dtype=torch.float32)
    assert TB.downdate_from_operands(ops, out=buf) is buf
    assert torch.equal(buf, TFD.packed_reference(*ops))
    xv = torch.ones((2, 3, K))
    m2 = torch.ones((2, 3, K + M))
    kvec = torch.ones((2, 2, K))
    cvec = torch.ones((2, 2, K + M))
    res = TFD.fold_downdate_f32(ops.total, xv, m2, kvec, cvec)
    assert res.dtype == torch.float32
    assert torch.equal(res, (ops.total - 4.0).expand(2, K, K + M))
    src = TB.prepare_loocv_sources(cfg, st, IDX_ONE)
    TB.loocv_from_sources(cfg, src, IDX_ONE[:, 0], return_XTY=True)
    assert (TFD.launch_counts(), TL.fused_loocv.launches_f32) == before
    assert set(TFD.launch_counts()) == {
        "fold_packed", "fold_packed_f32", "fold_downdate_f32",
        "fold_ozaki_df64", "fold_v3", "fold_v3_sym", "fold_epilogue",
        "fold_smallfold", "fold_smallfold_f32"}


_re = np.random.default_rng(32)
# 6 folds of 31 seeded rows (under LARGE_FOLD_ROWS = 32), and ragged folds
# of np.arange(N) % 7 (4 of 29 rows, 3 of 28) padded to 29 with a mask.
IDX_L31 = np.stack([_re.choice(N, 31, replace=False) for _ in range(6)])
_, IDX_RAGGED, MASK_RAGGED = J.Partitioner(np.arange(N) % 7).padded_batches()


@pytest.mark.parametrize("case", ["L=31", "ragged L=29, masked"])
@pytest.mark.parametrize("flags", [(True,) * 4, (False, True, True, False),
                                   (False,) * 4])
def test_packed_f32_route_at_tile_edges(interpret_pallas, flags, case):
    """The float32 packed route (the row-stream tile's float32 entry) at
    the largest fold size its gate gives it and on ragged masked folds,
    through training_matrices_batched, against fused_downdate_f32_packed in
    interpret mode and the JAX XLA f32 engine on the same seeded data and
    folds, at 1e-4 of the reference's largest entry; [XTX | XTY] and XTY
    alone."""
    idx, mask = ((IDX_L31, None) if case == "L=31"
                 else (IDX_RAGGED, MASK_RAGGED.astype(np.float32)))
    jcfg, js, cfg, st = fit_both(flags)
    for xtx in (True, False):
        assert TB.route_kernel(cfg, st, idx.shape[1], xtx, True,
                               mask is not None) == "packed_f32"
        got, _ = TB.training_matrices_batched(cfg, st, idx, mask,
                                              return_XTX=xtx)
        for impl in ("pallas", "xla"):
            ref, _ = JB.training_matrices_batched(jcfg, js, idx, mask,
                                                  return_XTX=xtx, impl=impl)
            assert_near(as_np(got), as_np(ref), msg=f"{case} {xtx=} {impl}")


# --------------------------------------------------------------------------- #
# TF32 repair                                                                 #
# --------------------------------------------------------------------------- #


@pytest.fixture
def restore_precision():
    """Give the process back its float32 matmul settings after the test."""
    cuda_mm = torch.backends.cuda.matmul
    cpu_mm = torch.backends.mkldnn.matmul
    legacy = torch.get_float32_matmul_precision()
    saved = (cuda_mm.fp32_precision, cpu_mm.fp32_precision)
    yield
    torch.set_float32_matmul_precision(legacy)
    cuda_mm.fp32_precision, cpu_mm.fp32_precision = saved


@pytest.fixture
def product_settings(monkeypatch):
    """Record, at every float32 product the port makes, which function made
    it and whether TF32 was allowed then."""
    seen = []

    def wrap(name, fn):
        def recorded(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.dtype == torch.float32
                   for a in args):
                seen.append((name, torch.backends.cuda.matmul.allow_tf32,
                             torch.get_float32_matmul_precision()))
            return fn(*args, **kwargs)
        return recorded

    for name in ("matmul", "bmm", "einsum"):
        monkeypatch.setattr(torch, name, wrap(name, getattr(torch, name)))
    monkeypatch.setattr(torch.Tensor, "__matmul__",
                        wrap("@", torch.Tensor.__matmul__))
    return seen


def test_tf32_off_inside_f32_products(restore_precision, product_settings):
    """Under ``set_float32_matmul_precision("high")`` and ``allow_tf32 =
    True`` (TF32 on the H100), every float32 product of the fit, the twins
    and the per-fold engine runs with TF32 off, and the caller's settings
    are back afterwards."""
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    cfg = T.CVConfig(dtype=np.float32)
    st = T.fit(cfg, X_ALL, Y_ALL, W_ALL, device="cpu")
    for idx, mask in ((IDX_ONE, None), (IDX_SMALL, _mask(IDX_SMALL)),
                      (IDX_LARGE, None)):
        TB.training_matrices_batched(cfg, st, idx, mask)
    T.training_matrices(cfg, st, IDX_SMALL[0])
    # no float32 route takes a bmm: the LOOCV statistics come from the
    # kernel (its twin here), the other routes' from gathered blocks
    assert {name for name, _, _ in product_settings} == {
        "matmul", "einsum", "@"}
    assert all(not tf32 and prec == "highest"
               for _, tf32, prec in product_settings), product_settings
    assert torch.get_float32_matmul_precision() == "high"
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_tf32_off_under_the_new_api(restore_precision):
    """A caller on the per-backend API alone (where torch refuses to read
    the legacy setting) gets TF32 off inside and its setting back."""
    cuda_mm = torch.backends.cuda.matmul
    cuda_mm.fp32_precision = "tf32"
    with pytest.raises(RuntimeError):
        torch.get_float32_matmul_precision()
    with TP.highest_precision():
        assert cuda_mm.fp32_precision == "ieee"
        assert cuda_mm.allow_tf32 is False
    assert cuda_mm.fp32_precision == "tf32"
