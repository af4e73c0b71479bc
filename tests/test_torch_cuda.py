"""Tests of the port that need a CUDA card (marked ``cuda``).

They skip with a reason where no card is present. This file imports no JAX,
so it also runs where JAX is not installed; run it on a GPU machine with::

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import cvmatrix_tpu_torch as T
from cvmatrix_tpu_torch.core import batch as TB
from cvmatrix_tpu_torch.models import sweep as TS
from cvmatrix_tpu_torch.ops import loocv as TL

pytestmark = pytest.mark.cuda

N, K, M = 300, 40, 5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.random(N)
    w[::9] = 0.0
    return rng.random((N, K)), rng.random((N, M)), w


@pytest.mark.parametrize("with_y", [True, False])
@pytest.mark.parametrize("flags", [(True,) * 4, (False,) * 4,
                                   (True, False, False, True),
                                   (False, True, True, False)])
def test_kernel_matches_twin(dev, flags, with_y):
    X, Y, w = _data()
    cfg = T.CVConfig(*flags)
    st = T.fit(cfg, X, Y if with_y else None, w, device=dev)
    rows = np.arange(0, N, 7)
    src = TB.prepare_loocv_sources(cfg, st, rows, return_XTY=with_y)
    before = TL.fused_loocv.launches
    got = TB.loocv_from_sources(cfg, src, rows, return_XTY=with_y)
    assert TL.fused_loocv.launches == before + 1
    ref = TB.loocv_from_sources(cfg, src, rows, return_XTY=with_y,
                                impl="torch")
    torch.cuda.synchronize()
    # FMA contraction in the kernel: a few ulps of the largest entry.
    assert (got - ref).abs().max().item() <= 1e-12 * ref.abs().max().item()


def test_sweep_probe_matches_cpu(dev):
    X, Y, w = _data(1)
    idx = np.arange(N)[:, None]
    cfg = T.CVConfig()
    got = TS.materialize_cv(cfg, X, Y, w, idx, batch_size=64, device=dev)
    ref = TS.materialize_cv(cfg, X, Y, w, idx, batch_size=64)
    assert abs(float(got) - float(ref)) <= 1e-10 * abs(float(ref))


def test_unported_cuda_routes_raise(dev):
    X, Y, w = _data(2)
    cfg32 = T.CVConfig(dtype=np.float32)
    st32 = T.fit(cfg32, X, Y, w, device=dev)
    src = TB.prepare_loocv_sources(cfg32, st32, np.arange(4))
    with pytest.raises(NotImplementedError, match="fused_loocv_f32"):
        TB.loocv_from_sources(cfg32, src, np.arange(4), return_XTY=True)
    st = T.fit(T.CVConfig(), X, Y, w, device=dev)
    with pytest.raises(NotImplementedError, match="fused_downdate_df64_packed"):
        TS.materialize_sweep(T.CVConfig(), st, np.arange(N).reshape(-1, 3))
    # the plain engine stays available on the card when asked for
    TS.materialize_sweep(T.CVConfig(), st, np.arange(N).reshape(-1, 3),
                         impl="torch")
