"""The port's reduce sweeps against the JAX package's on the CPU.

``cross_validate_reduce`` is held against the JAX function of the same name
for each of its bodies (the hoisted LOOCV, packed and v3 fold plans, and
the generic per-chunk body), which the port runs on the CPU with the
kernels' twins: LOOCV, L=4, L=10 and L=100, a large-fold batch, masked
padded batches, XTX alone, XTY alone, float32, ``hoist_reduce`` off,
``sym_loocv`` and ``df64x2`` on, with a trace reduction and with the ridge
solve of ``examples/cross_validation_reduce.py`` (in float64). Bounds:
1e-10 of the largest entry for matrices and traces in float64, 1e-4 in
float32, and for the solve ``2e-10 * cond(A)`` of the largest coefficient
(the perturbation bound of a linear solve whose matrix and right-hand side
agree to 1e-10). ``cross_validate``, ``cross_validate_dict`` and
``CVMatrix.cross_validate_reduce`` are held against theirs, keys included.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import cvmatrix_tpu as J
import cvmatrix_tpu_torch as T
from cvmatrix_tpu.models import sweep as JS
from cvmatrix_tpu_torch.core import batch as TB
from cvmatrix_tpu_torch.models import sweep as TS

N = 300
_rng = np.random.default_rng(17)
X_W = _rng.normal(size=(N, 130)) * 2 + 0.5   # K=130 for the sym routes
Y_A = _rng.normal(size=(N, 3))
W_A = _rng.uniform(0, 2, size=N)
W_A[::13] = 0.0
FOLDS = _rng.integers(0, 7, size=N)          # ragged: masked padded batch
FLAGS = (True, True, True, True)
LAM = 1e-6


@pytest.fixture(autouse=True)
def _restore_policies():
    before = J.policy(), T.policy()
    yield
    J.set_routing(**dataclasses.asdict(before[0]))
    T.set_routing(**dataclasses.asdict(before[1]))


@pytest.fixture
def plans(monkeypatch):
    """The routes of the fold plans built (``core.batch._plan``): one for
    every fold in a hoisted body, one a chunk in the generic body."""
    built = []

    def spy(config, state, route, *a, _fn=TB._plan, **kw):
        plan = _fn(config, state, route, *a, **kw)
        if plan is not None:
            built.append(route)
        return plan
    monkeypatch.setattr(TB, "_plan", spy)
    return built


def built_as(plans, expect, n_folds, batch_size):
    """``plans`` are those of the case's body: ``expect = (route,
    hoisted)``."""
    route, hoisted = expect
    chunks = 1 if hoisted else -(-n_folds // min(batch_size, n_folds))
    assert plans == [route] * chunks


def _pick(mats):
    return mats[0] if isinstance(mats, tuple) else mats


def trace_t(mats, stats):
    x = _pick(mats)
    return torch.trace(x), (x.sum() if stats[1] is None else stats[1].sum())


def trace_j(mats, stats):
    x = _pick(mats)
    return jnp.trace(x), (x.sum() if stats[1] is None else stats[1].sum())


def ridge_t(mats, stats):
    xtx, xty = mats
    eye = torch.eye(xtx.shape[0], dtype=xtx.dtype, device=xtx.device)
    return torch.linalg.solve(xtx + LAM * eye, xty)


def ridge_j(mats, stats):
    xtx, xty = mats
    return jnp.linalg.solve(xtx + LAM * jnp.eye(xtx.shape[0], dtype=xtx.dtype),
                            xty)


def both(k, dtype=np.float64, mode="auto", weighted=True):
    x, y, w = (a.astype(dtype) for a in (X_W[:, :k], Y_A, W_A))
    jcfg = J.CVConfig(*FLAGS, dtype=dtype, matmul_mode=mode)
    js = J.fit(jcfg, x, y, w if weighted else None)
    st = T.FitState.from_numpy({f.name: None if getattr(js, f.name) is None
                                else np.asarray(getattr(js, f.name))
                                for f in dataclasses.fields(js)})
    return jcfg, js, T.CVConfig(*FLAGS, dtype=dtype, matmul_mode=mode), st


def close(got, ref, rtol):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape
        assert np.abs(g.numpy() - r).max() <= rtol * max(np.abs(r).max(),
                                                         1e-300)


def _masked():
    _, idx, mask = J.Partitioner(FOLDS).padded_batches()
    return idx, mask


# name: (K, fold batch, mask, knobs, extra kwargs, dtype, mode, (route of
# the fold plans, whether the body is hoisted))
CASES = {
    "loocv": (6, np.arange(N)[:, None], None, {}, {}, np.float64, "auto",
              ("loocv", True)),
    "loocv_df64x2": (6, np.arange(N)[:, None], None, dict(df64x2=True), {},
                     np.float64, "auto", ("loocv_x2", True)),
    "loocv_sym": (130, np.arange(N)[:, None], None, dict(sym_loocv=True), {},
                  np.float64, "auto", ("loocv_sym", True)),
    "loocv_xtx_only": (6, np.arange(N)[:, None], None, {},
                       dict(return_XTY=False), np.float64, "auto",
                       ("loocv", True)),
    "packed_l4": (6, np.arange(N).reshape(75, 4), None, {}, {}, np.float64,
                  "auto", ("packed", True)),
    "packed_xty_only": (6, np.arange(N).reshape(75, 4), None, {},
                        dict(return_XTX=False), np.float64, "auto",
                        ("packed", True)),
    "v3_l10": (6, np.arange(N).reshape(30, 10), None, {}, {}, np.float64,
               "auto", ("v3", True)),
    "v3_l100": (6, np.arange(N).reshape(3, 100), None, {}, {}, np.float64,
                "auto", ("v3", True)),
    "v3_sym_l10": (130, np.arange(N).reshape(30, 10), None,
                   dict(sym_loocv=True), {}, np.float64, "auto",
                   ("v3_sym", True)),
    "v3_masked": (6, "padded", None, {}, {}, np.float64, "auto",
                  ("v3", True)),
    "v3_hoist_off": (6, np.arange(N).reshape(30, 10), None,
                     dict(hoist_reduce=False), {}, np.float64, "auto",
                     ("v3", False)),
    "large_fold_generic": (6, np.arange(280).reshape(7, 40), None, {}, {},
                           np.float64, "native", ("epilogue", False)),
    "f32_loocv": (6, np.arange(N)[:, None], None, dict(f32x2=True), {},
                  np.float32, "auto", ("loocv_x2", True)),
    "f32_packed_l4": (6, np.arange(N).reshape(75, 4), None, {}, {},
                      np.float32, "auto", ("packed_f32", True)),
    "f32_masked_generic": (6, "padded", None, {}, {}, np.float32, "auto",
                           ("downdate_f32", False)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cross_validate_reduce_matches_jax(case, plans):
    k, idx, mask, knobs, kw, dtype, mode, expect = CASES[case]
    if isinstance(idx, str):
        idx, mask = _masked()
    jcfg, js, cfg, st = both(k, dtype, mode)
    T.set_routing(**knobs)
    J.set_routing(**knobs)
    got = TS.cross_validate_reduce(cfg, st, idx, mask, reduce_fn=trace_t,
                                   batch_size=16, **kw)
    built_as(plans, expect, idx.shape[0], 16)
    ref = JS.cross_validate_reduce(jcfg, js, idx, mask, reduce_fn=trace_j,
                                   batch_size=16, **kw)
    assert got[0].dtype == (torch.float64 if dtype == np.float64
                            else torch.float32)
    close(got, ref, 1e-10 if dtype == np.float64 else 1e-4)


@pytest.mark.parametrize("n_l,knobs", [
    (1, {}), (1, dict(sym_loocv=True)), (10, {}),
    (10, dict(hoist_reduce=False)), (4, {})])
def test_ridge_solve_matches_jax(n_l, knobs):
    """The per-fold ridge coefficients of the example, float64 solves."""
    jcfg, js, cfg, st = both(130 if knobs.get("sym_loocv") else 6)
    T.set_routing(**knobs)
    J.set_routing(**knobs)
    idx = np.arange(N).reshape(-1, n_l)
    got = TS.cross_validate_reduce(cfg, st, idx, reduce_fn=ridge_t,
                                   batch_size=32).numpy()
    ref = np.asarray(JS.cross_validate_reduce(jcfg, js, idx,
                                              reduce_fn=ridge_j,
                                              batch_size=32))
    mats, _ = T.training_matrices(cfg, st, idx)
    eye = np.eye(st.K)
    cond = max(np.linalg.cond(a + LAM * eye) for a in mats[0].numpy())
    assert np.abs(got - ref).max() <= 2e-10 * cond * np.abs(ref).max()


def test_reduce_keeps_fold_order_and_drops_padding():
    """Seven-fold chunks over 300 folds: padded to 301 by repeating the
    last fold; the result has 300 entries, each its own fold's."""
    _, _, cfg, st = both(6)
    idx = np.arange(N).reshape(-1, 1)[::-1].copy()
    got = TS.cross_validate_reduce(cfg, st, idx, reduce_fn=trace_t,
                                   batch_size=7, donate_state=True)
    assert got[0].shape == (N,)
    (xtx, _), _ = T.training_matrices(cfg, st, idx[[0, -1]])
    assert_allclose(got[0][[0, -1]].numpy(),
                    torch.diagonal(xtx, dim1=1, dim2=2).sum(1).numpy(),
                    rtol=1e-12)


@pytest.mark.parametrize("use_padding", [False, True])
def test_cross_validate_and_dict_match_jax(use_padding):
    jcfg, js, cfg, st = both(6)
    jp, tp = J.Partitioner(FOLDS), T.Partitioner(FOLDS)
    got = list(TS.cross_validate(cfg, st, tp, batch_size=3,
                                 use_padding=use_padding))
    ref = list(JS.cross_validate(jcfg, js, jp, batch_size=3,
                                 use_padding=use_padding))
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (_, g), (_, r) in zip(got, ref):
        (gx, gy), gs = g
        (rx, ry), rs = r
        close((gx, gy, *gs), (rx, ry, *rs), 1e-10)
    gd = TS.cross_validate_dict(cfg, st, tp, use_padding=use_padding)
    rd = JS.cross_validate_dict(jcfg, js, jp, use_padding=use_padding)
    assert list(gd) == list(rd)
    for key in rd:
        (gx, gy), gs = gd[key]
        (rx, ry), rs = rd[key]
        close((gx, gy, *gs), (rx, ry, *rs), 1e-10)


def test_cvmatrix_cross_validate_reduce_matches_jax():
    x, y = X_W[:, :6], Y_A
    tm = T.CVMatrix(*FLAGS, device="cpu").fit(x, y, W_A)
    jm = J.CVMatrix(*FLAGS).fit(x, y, W_A)
    tk, got = tm.cross_validate_reduce(T.Partitioner(FOLDS),
                                       reduce_fn=trace_t, batch_size=4)
    jk, ref = jm.cross_validate_reduce(J.Partitioner(FOLDS),
                                       reduce_fn=trace_j, batch_size=4)
    assert tk == jk
    close(got, ref, 1e-10)


def test_reduce_argument_errors():
    _, _, cfg, st = both(6)
    idx = np.arange(N)[:, None]
    with pytest.raises(ValueError, match="Unknown impl"):
        TS.cross_validate_reduce(cfg, st, idx, reduce_fn=trace_t, impl="xla")
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        TS.cross_validate_reduce(cfg, st, idx, reduce_fn=trace_t,
                                 impl="cuda")
    with pytest.raises(ValueError, match="At least one"):
        TS.cross_validate_reduce(cfg, st, idx, reduce_fn=trace_t,
                                 return_XTX=False, return_XTY=False)
    with pytest.raises(ValueError, match="fit\\(\\) must be called"):
        T.CVMatrix(device="cpu").cross_validate_reduce(
            T.Partitioner(FOLDS), reduce_fn=trace_t)


def view_t(mats, stats):
    """A reduction that is a view of the fold's matrices."""
    xtx, xty = mats
    return {"row": xty[:, 0], "diag": xtx.diagonal()}


@pytest.mark.parametrize("case", ["loocv", "packed_l4", "v3_l10",
                                  "large_fold_generic"])
def test_view_reductions_hold_no_chunk(case, plans, monkeypatch):
    """Each body's per-chunk reductions own their storage: a view of the
    chunk's matrices (``xty[:, 0]``) would hold the whole (F, K, C) output
    alive until the sweep ends (31 GB above the fit at K=20,000); the
    results equal the per-fold engine's."""
    k, idx, _, knobs, _, dtype, mode, expect = CASES[case]
    _, _, cfg, st = both(k, dtype, mode)
    chunks = []

    def spy(parts, _fn=TS._stack_chunks):
        chunks.extend(parts)
        return _fn(parts)

    monkeypatch.setattr(TS, "_stack_chunks", spy)
    got = TS.cross_validate_reduce(cfg, st, idx, reduce_fn=view_t,
                                   batch_size=7)
    built_as(plans, expect, idx.shape[0], 7)
    assert len(chunks) == -(-idx.shape[0] // 7)
    for leaf in (a for c in chunks for a in c.values()):
        assert leaf.untyped_storage().nbytes() == (leaf.numel()
                                                   * leaf.element_size())
    (xtx, xty), _ = T.training_matrices(cfg, st, idx)
    assert_allclose(got["row"].numpy(), xty[:, :, 0].numpy(), rtol=1e-10,
                    atol=1e-10 * float(xty.abs().max()))
    assert_allclose(got["diag"].numpy(),
                    xtx.diagonal(dim1=1, dim2=2).numpy(), rtol=1e-10,
                    atol=1e-10 * float(xtx.abs().max()))


def stats_view_t(mats, stats):
    """A reduction that is a view of the fold's statistics."""
    del mats
    return {"x_std": stats[1][0], "y_mean": stats[2][0]}


@pytest.mark.parametrize("case", ["loocv", "loocv_sym", "packed_l4",
                                  "v3_l10", "large_fold_generic"])
def test_stats_view_reductions_hold_no_buffer(case, plans, monkeypatch):
    """Each body's per-chunk reductions of statistics own their storage: a
    view of the chunk's statistics would hold the buffer they came in (on
    the LOOCV plan the (F, 2, C) one the kernel stores them in) alive until
    the sweep ends; the results equal the per-fold engine's."""
    k, idx, _, knobs, _, dtype, mode, expect = CASES[case]
    T.set_routing(**knobs)
    _, _, cfg, st = both(k, dtype, mode)
    chunks = []

    def spy(parts, _fn=TS._stack_chunks):
        chunks.extend(parts)
        return _fn(parts)

    monkeypatch.setattr(TS, "_stack_chunks", spy)
    got = TS.cross_validate_reduce(cfg, st, idx, reduce_fn=stats_view_t,
                                   batch_size=7)
    built_as(plans, expect, idx.shape[0], 7)
    assert len(chunks) == -(-idx.shape[0] // 7)
    for leaf in (a for c in chunks for a in c.values()):
        assert leaf.untyped_storage().nbytes() == (leaf.numel()
                                                   * leaf.element_size())
    _, (_, x_std, y_mean, _) = T.training_matrices(cfg, st, idx)
    assert_allclose(got["x_std"].numpy(), x_std[:, 0].numpy(), rtol=1e-12)
    assert_allclose(got["y_mean"].numpy(), y_mean[:, 0].numpy(), rtol=1e-12,
                    atol=1e-12 * float(y_mean.abs().max()))
