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
from cvmatrix_tpu_torch.ops import loocv as TL

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
    st = port_state(J.fit(J.CVConfig(), X_ALL, Y_ALL, W_ALL))
    with pytest.raises(NotImplementedError, match="fused_smallfold_df64"):
        TB.prepare_loocv_sources(T.CVConfig(), st, IDX.reshape(3, 2))
    with pytest.raises(NotImplementedError, match="fused_smallfold_df64"):
        TB.prepare_loocv_sources(T.CVConfig(), st, IDX[:, None],
                                 np.ones((len(IDX), 1)))
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
