"""The small-fold route of the port: LOOCV sources of (F, L) folds with an
optional mask, and the plain twin of the port of ``fused_smallfold_df64``.

The JAX state is fed to the port through ``FitState.from_numpy`` so the
fold math is held apart from the fit. The twin is held against the JAX
package's vmapped engine (``training_matrices_batched(impl="xla")``) at
1e-8 over 16 flag sets x weights x Y x mask, against the JAX package's
eager CPU model of its Pallas kernel (``fused_smallfold_df64_reference``)
at 1e-8, and against that kernel in interpret mode
(``smallfold_from_sources(..., interpret=True)``) at 1e-5 of the largest
entry, the JAX package's own wiring bound (``tests/test_loocv_kernel.py``:
the interpreter fuses ``a*b+c`` and breaks the double-float compensation).
Float32 sources are held against the JAX f32 XLA engine at 1e-4 of the
largest entry (float32 sums in another order). The whole slice, a
``Partitioner`` with unequal folds through ``padded_batches``, the sources
and the route in two chunks, is held against ``tests/oracle.py``. The CUDA
kernel itself is checked on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.
"""

import dataclasses
from itertools import product

import jax.numpy as jnp
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

from .oracle import NaiveOracle

N, K, M = 70, 9, 4
rng = np.random.default_rng(11)
X_ALL = rng.normal(size=(N, K)) * 3 + 1
Y_ALL = rng.normal(size=(N, M))
W_ALL = rng.uniform(0, 2, size=N)
W_ALL[::7] = 0.0

IDX_L = np.arange(24).reshape(6, 4)        # 6 folds of 4 rows
MASK_L = np.ones((6, 4))
MASK_L[2, 3] = 0.0                          # one padded row
MASK_L[5, 2:] = 0.0                         # two padded rows


def port_state(js):
    return T.FitState.from_numpy({
        f.name: None if getattr(js, f.name) is None
        else np.asarray(getattr(js, f.name))
        for f in dataclasses.fields(js)
    })


def jflags(cfg, with_y):
    return dict(center_xtx=cfg.center_X,
                center_xty=cfg.center_X or cfg.center_Y,
                scale_x=cfg.scale_X, scale_y=cfg.scale_Y, with_y=with_y,
                resolution=cfg.resolution)


def run_port(flags, weighted, with_y, mask, dtype=np.float64, impl="auto"):
    """``(JAX config, JAX state, port result)`` of the folds IDX_L."""
    jcfg = J.CVConfig(*flags, dtype=dtype)
    x, y = X_ALL.astype(dtype), Y_ALL.astype(dtype)
    js = J.fit(jcfg, x, y if with_y else None,
               W_ALL.astype(dtype) if weighted else None)
    cfg = T.CVConfig(*flags, dtype=dtype)
    st = port_state(js)
    src = TB.prepare_loocv_sources(cfg, st, IDX_L, mask, return_XTY=with_y)
    out = TB.smallfold_from_sources(
        cfg, src, IDX_L.reshape(-1), n_l=IDX_L.shape[1], return_XTY=with_y,
        has_mask=mask is not None, impl=impl)
    return jcfg, js, out


def jax_engine(jcfg, js, mask, with_y):
    ref, _ = JB.training_matrices_batched(
        jcfg, js, IDX_L, mask, return_XTX=True, return_XTY=with_y,
        impl="xla")
    if with_y:
        return np.concatenate([np.asarray(r) for r in ref], axis=2)
    return np.asarray(ref)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_y", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("flags", list(product([False, True], repeat=4)))
def test_twin_matches_jax_engine(flags, weighted, with_y, masked):
    mask = MASK_L if masked else None
    jcfg, js, out = run_port(flags, weighted, with_y, mask)
    assert out.shape == (IDX_L.shape[0], K, K + (M if with_y else 0))
    assert out.dtype == torch.float64
    assert_allclose(out.numpy(), jax_engine(jcfg, js, mask, with_y),
                    atol=1e-8, rtol=0)


def _jax_sources(jcfg, js, mask, with_y):
    return JB.prepare_loocv_sources(jcfg, js, IDX_L, mask, return_XTX=True,
                                    return_XTY=with_y, presplit=False)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("flags", [(True,) * 4, (False, True, True, False)])
def test_twin_matches_jax_kernel_model(flags, masked):
    """Against the eager CPU model of the Pallas kernel (double-float pairs
    on padded tiles), converted to f64 and trimmed to (K, C)."""
    mask = MASK_L if masked else None
    jcfg, js, out = run_port(flags, True, True, mask)
    src = _jax_sources(jcfg, js, mask, True)
    pair = JK.fused_smallfold_df64_reference(
        IDX_L, mask, src.total4, src.xw, src.xu, src.yu, src.yw, src.gx,
        src.gy, src.ymask, src.scal, **jflags(jcfg, True))
    ref = np.asarray(df_to_f64(pair[:, 0], pair[:, 1]))[:, :K, :K + M]
    assert_allclose(out.numpy(), ref, atol=1e-8, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_twin_matches_jax_kernel_interpret(masked):
    """Against ``smallfold_from_sources`` in interpret mode (the Pallas
    kernel on the CPU) at 1e-5 of the largest entry."""
    mask = MASK_L if masked else None
    jcfg, js, out = run_port((True,) * 4, True, True, mask)
    src = _jax_sources(jcfg, js, mask, True)
    pair = JB.smallfold_from_sources(
        jcfg, src, jnp.asarray(IDX_L.reshape(-1), jnp.int32),
        n_l=IDX_L.shape[1], return_XTY=True, has_mask=masked,
        interpret=True)
    ref = np.asarray(df_to_f64(pair[:, 0], pair[:, 1]))[:, :K, :K + M]
    scale = np.abs(ref).max()
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * scale


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("flags", [(True,) * 4, (False,) * 4,
                                   (True, False, False, True),
                                   (False, True, True, False)])
def test_f32_twin_matches_jax_f32_engine(flags, masked):
    """Float32 sources run in float32 and meet the JAX f32 XLA engine at
    1e-4 of its largest entry."""
    mask = MASK_L if masked else None
    jcfg, js, out = run_port(flags, True, True, mask, dtype=np.float32)
    assert out.dtype == torch.float32
    ref = jax_engine(jcfg, js, mask, True)
    scale = np.abs(ref).max()
    assert np.abs(out.numpy() - ref).max() <= 1e-4 * scale


def test_whole_slice_against_oracle():
    """Every fold of a Partitioner with unequal folds (4 and 5 rows),
    padded to L=5 with a mask, through prepare_loocv_sources and
    smallfold_from_sources in two chunks, against tests/oracle.py."""
    flags = (True, True, True, True)
    folds = np.arange(N) % 16  # 6 folds of 5 rows, 10 of 4
    cvm = T.CVMatrix(*flags, device="cpu").fit(X_ALL, Y_ALL, W_ALL)
    keys, idx, mask = T.Partitioner(folds).padded_batches()
    assert mask is not None and idx.shape == (16, 5)
    assert (mask.sum(axis=1) == 4).sum() == 10
    cfg, st = cvm.config, cvm.state
    src = TB.prepare_loocv_sources(cfg, st, idx, mask)
    assert src.mask.shape == idx.shape and src.mask.dtype == torch.float64
    oracle = NaiveOracle(*flags).fit(X_ALL, Y_ALL, W_ALL)
    bs = 9
    for start in range(0, idx.shape[0], bs):
        sl = slice(start, start + bs)
        out = TB.smallfold_from_sources(cfg, src, idx[sl], src.scal[sl],
                                        src.mask[sl], n_l=idx.shape[1],
                                        return_XTY=True, has_mask=True)
        for f in range(out.shape[0]):
            rows = idx[start + f][mask[start + f] > 0]
            (xtx, xty), _ = oracle.training_XTX_XTY(
                np.delete(np.arange(N), rows))
            assert_allclose(out[f, :, :K].numpy(), xtx, atol=1e-8, rtol=0)
            assert_allclose(out[f, :, K:].numpy(), xty, atol=1e-8, rtol=0)


def test_loocv_route_refuses_smallfold_sources():
    """The LOOCV kernels read one unmasked row a fold, so sources of more
    rows, or with a mask, raise and name the small-fold entry."""
    cfg = T.CVConfig()
    st = port_state(J.fit(J.CVConfig(), X_ALL, Y_ALL, W_ALL))
    multi = TB.prepare_loocv_sources(cfg, st, IDX_L)
    masked = TB.prepare_loocv_sources(cfg, st, IDX_L[:, :1],
                                      np.ones((IDX_L.shape[0], 1)))
    for src, rows in ((multi, IDX_L), (multi, IDX_L.reshape(-1)),
                      (masked, IDX_L[:, 0])):
        with pytest.raises(ValueError, match="smallfold_from_sources"):
            TB.loocv_from_sources(cfg, src, rows, return_XTY=True)
        with pytest.raises(ValueError, match="smallfold_from_sources"):
            TB.run_loocv_route(cfg, src, rows, "loocv", return_XTY=True)


def test_smallfold_wrapper_on_cpu():
    """On CPU tensors the wrapper runs its twin: it fills ``out``, counts
    no launch, and refuses a CUDA request and malformed arguments."""
    cfg = T.CVConfig()
    st = port_state(J.fit(J.CVConfig(), X_ALL, Y_ALL, W_ALL))
    src = TB.prepare_loocv_sources(cfg, st, IDX_L, MASK_L)
    before = TFD.launch_counts()
    buf = torch.empty((IDX_L.shape[0], K, K + M), dtype=torch.float64)
    got = TB.smallfold_from_sources(cfg, src, IDX_L, n_l=4, return_XTY=True,
                                    has_mask=True, out=buf)
    assert got is buf
    assert TFD.launch_counts() == before
    assert {"fold_smallfold", "fold_smallfold_f32"} <= set(before)
    ref = TFD.smallfold_reference(
        src.total, src.xw, src.xu, src.yu, src.yw, torch.as_tensor(IDX_L),
        src.mask, src.gx, src.gy, src.scal, **TB._loocv_flags(cfg, True))
    assert torch.equal(buf, ref)
    # the mask matters: without it the padded rows count
    plain = TB.smallfold_from_sources(cfg, src, IDX_L, n_l=4,
                                      return_XTY=True, has_mask=False)
    assert not torch.equal(plain, buf)
    with pytest.raises(ValueError, match="impl='cuda'"):
        TB.smallfold_from_sources(cfg, src, IDX_L, n_l=4, return_XTY=True,
                                  has_mask=True, impl="cuda")
    with pytest.raises(ValueError, match="not a multiple"):
        TB.smallfold_from_sources(cfg, src, IDX_L.reshape(-1)[:-1], n_l=4,
                                  return_XTY=True, has_mask=True)
    unmasked = TB.prepare_loocv_sources(cfg, st, IDX_L)
    with pytest.raises(ValueError, match="has_mask"):
        TB.smallfold_from_sources(cfg, unmasked, IDX_L, n_l=4,
                                  return_XTY=True, has_mask=True)
    with pytest.raises(ValueError, match="outside"):
        TB.smallfold_from_sources(cfg, src, IDX_L + N, n_l=4,
                                  return_XTY=True, has_mask=True)
