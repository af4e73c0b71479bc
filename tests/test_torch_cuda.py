"""Tests of the port that need a CUDA card (marked ``cuda``).

They skip with a reason where no card is present. This file imports no JAX,
so it also runs where JAX is not installed; run it on a GPU machine with::

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import itertools

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import cvmatrix_tpu_torch as T
from cvmatrix_tpu_torch.core import batch as TB
from cvmatrix_tpu_torch.models import sweep as TS
from cvmatrix_tpu_torch.ops import fold_downdate as TFD
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
    ref = TS.materialize_cv(cfg, X, Y, w, idx, batch_size=64, device="cpu")
    assert abs(float(got) - float(ref)) <= 1e-10 * abs(float(ref))


def test_unported_cuda_routes_raise(dev):
    """No route is left unported: a float32 batch of two-row LOOCV
    sources launches the small-fold kernel once and returns float32,
    float32 batches launch the f32 engine's kernels and every float64
    K-fold batch runs."""
    X, Y, w = _data(2)
    cfg32 = T.CVConfig(dtype=np.float32)
    st32 = T.fit(cfg32, X, Y, w, device=dev)
    idx2 = np.arange(8).reshape(4, 2)
    src2 = TB.prepare_loocv_sources(cfg32, st32, idx2)
    before = TFD.launch_counts()
    out2 = TB.smallfold_from_sources(cfg32, src2, idx2, n_l=2,
                                     return_XTY=True, has_mask=False)
    after = TFD.launch_counts()
    assert out2.dtype == torch.float32 and out2.shape == (4, K, K + M)
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"fold_smallfold_f32": 1}
    src = TB.prepare_loocv_sources(cfg32, st32, np.arange(4))
    before = TL.fused_loocv.launches_f32
    out = TB.loocv_from_sources(cfg32, src, np.arange(4), return_XTY=True)
    assert out.dtype == torch.float32
    assert TL.fused_loocv.launches_f32 == before + 1
    idx3 = np.arange(N).reshape(-1, 3)
    TFD.reset_launch_counts()
    TS.materialize_sweep(cfg32, st32, idx3, batch_size=25)
    TB.training_matrices_batched(cfg32, st32, np.arange(N).reshape(-1, 50))
    counts = TFD.launch_counts()
    assert counts == {**{n: 0 for n in counts}, "fold_packed_f32": 4,
                      "fold_downdate_f32": 1}
    # the plain engine stays available on the card when asked for
    TS.materialize_sweep(cfg32, st32, idx3, impl="torch")
    assert TFD.launch_counts() == counts
    st = T.fit(T.CVConfig(), X, Y, w, device=dev)
    for n_l in (3, 50):
        TS.materialize_sweep(T.CVConfig(), st, np.arange(N).reshape(-1, n_l))


# float32 fold batches: (fold rows, masked) -> the kernel of its route
F32_CASES = [(1, False), (1, True), (4, False), (31, True), (32, False),
             (200, True)]
F32_KERNEL = {"loocv": "fused_loocv_f32", "packed_f32": "fold_packed_f32",
              "downdate_f32": "fold_downdate_f32"}


def _f32_counts():
    return {**TFD.launch_counts(), "fused_loocv": TL.fused_loocv.launches,
            "fused_loocv_f32": TL.fused_loocv.launches_f32}


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("xtx,xty", [(True, True), (True, False),
                                     (False, True)])
@pytest.mark.parametrize("flags", [(True,) * 4, (False,) * 4,
                                   (True, False, False, True),
                                   (False, True, True, False)])
def test_f32_routes_match_twin(dev, flags, xtx, xty, weighted):
    """Each float32 route through its kernel against its twin at 1e-4 of
    the twin's largest entry (float32 sums in another order), with that
    kernel's launch counter moving by one and no other."""
    rng = np.random.default_rng(6)
    X, Y = rng.random((N_ROUTES, K)), rng.random((N_ROUTES, M))
    w = rng.random(N_ROUTES) if weighted else None
    cfg = T.CVConfig(*flags, dtype=np.float32)
    st = T.fit(cfg, X, Y if xty else None, w, device=dev)
    for n_l, masked in F32_CASES:
        idx = _folds(n_l, 5, n_l)
        mask = None
        if masked:
            mask = np.ones(idx.shape)
            mask[::2, -1] = 0.0
        route = TB.route_kernel(cfg, st, n_l, xtx, xty, masked)
        before = _f32_counts()
        got, gs = TB.training_matrices_batched(cfg, st, idx, mask,
                                               return_XTX=xtx,
                                               return_XTY=xty)
        after = _f32_counts()
        launched = {k for k in after if after[k] != before[k]}
        assert launched == {F32_KERNEL[route]}, (n_l, route, launched)
        ref, rs = TB.training_matrices_batched(cfg, st, idx, mask,
                                               return_XTX=xtx,
                                               return_XTY=xty, impl="torch")
        torch.cuda.synchronize()
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            assert a.dtype == torch.float32
            assert (a - b).abs().max().item() <= (
                1e-4 * b.abs().max().item()), (n_l, route)
        for a, b in zip(gs, rs):
            assert (a is None) == (b is None)


@pytest.mark.parametrize("n_l", [1, 4, 7, 40])
def test_f32_sweep_probe_matches_cpu(dev, n_l):
    """Float32 materialize_cv on the card against the same sweep on the
    CPU (the twins): LOOCV, packed f32, masked packed f32 and masked
    fused_downdate."""
    X, Y, w = _data(7)
    _, idx, mask = T.Partitioner(np.arange(N) % (N // n_l)).padded_batches()
    cfg = T.CVConfig(dtype=np.float32)
    got = TS.materialize_cv(cfg, X, Y, w, idx, mask, batch_size=7,
                            device=dev)
    ref = TS.materialize_cv(cfg, X, Y, w, idx, mask, batch_size=7,
                            device="cpu")
    assert got.dtype == torch.float32
    assert abs(float(got) - float(ref)) <= 1e-4 * abs(float(ref))


def test_f32_fit_bit_identical_under_tf32(dev):
    """The float32 fit under set_float32_matmul_precision("high") and
    allow_tf32 (TF32 on the H100) equals, bit for bit, the fit under
    "highest"; a bare float32 product under "high" does not."""
    rng = np.random.default_rng(8)
    X = torch.from_numpy(rng.random((4000, 300), dtype=np.float32)).to(dev)
    Y = torch.from_numpy(rng.random((4000, 10), dtype=np.float32)).to(dev)
    cfg = T.CVConfig(dtype=np.float32)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
        st_high = T.fit(cfg, X, Y)
        bare_high = X.T @ X
        assert torch.get_float32_matmul_precision() == "high"
        torch.set_float32_matmul_precision("highest")
        st = T.fit(cfg, X, Y)
        bare = X.T @ X
    finally:
        torch.set_float32_matmul_precision(prev)
    for name, v in vars(st).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, getattr(st_high, name)), name
    assert not torch.equal(bare, bare_high)


# fold rows -> the kernel the route launches (K=40, M=5: one 128-tile)
ROUTE_CASES = [(4, "fold_packed"), (20, "fold_v3"), (150, "fold_v3"),
               (500, "fold_ozaki_df64")]
N_ROUTES = 700


def _folds(n_l, n_folds, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(N_ROUTES, n_l, replace=False)
                     for _ in range(n_folds)])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("xtx,xty", [(True, True), (True, False),
                                     (False, True)])
@pytest.mark.parametrize("flags", [(True,) * 4, (False,) * 4,
                                   (True, False, False, True),
                                   (False, True, True, False)])
def test_fold_routes_match_twin(dev, flags, xtx, xty, masked):
    """Each float64 K-fold route through its kernel against its twin, with
    the launch counter of that kernel moving by one."""
    rng = np.random.default_rng(3)
    X, Y = rng.random((N_ROUTES, K)), rng.random((N_ROUTES, M))
    w = rng.random(N_ROUTES)
    w[::9] = 0.0
    cfg = T.CVConfig(*flags)
    st = T.fit(cfg, X, Y if xty else None, w, device=dev)
    for n_l, name in ROUTE_CASES:
        idx = _folds(n_l, 5, n_l)
        mask = None
        if masked:
            mask = np.ones(idx.shape)
            mask[:, -2:] = 0.0
        route = TB.route_kernel(cfg, st, n_l, xtx, xty, masked)
        before = TFD.launch_counts()
        got, gs = TB.training_matrices_batched(cfg, st, idx, mask,
                                               return_XTX=xtx,
                                               return_XTY=xty)
        after = TFD.launch_counts()
        launched = {k for k in after if after[k] != before[k]}
        expect = {"packed": "fold_packed", "v3": "fold_v3",
                  "ozaki_df64": "fold_ozaki_df64",
                  "epilogue": "fold_epilogue"}[route]
        assert launched == {expect}, (n_l, route, launched)
        if xtx:
            assert expect == name
        ref, rs = TB.training_matrices_batched(cfg, st, idx, mask,
                                               return_XTX=xtx,
                                               return_XTY=xty, impl="torch")
        torch.cuda.synchronize()
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            assert (a - b).abs().max().item() <= (
                1e-12 * b.abs().max().item())
        for a, b in zip(gs, rs):
            assert (a is None) == (b is None)


def test_epilogue_route_matches_twin(dev):
    """Folds over 1024 rows: torch.bmm product, then the in-place epilogue
    kernel."""
    rng = np.random.default_rng(4)
    n = 1500
    X, Y, w = rng.random((n, K)), rng.random((n, M)), rng.random(n)
    cfg = T.CVConfig()
    st = T.fit(cfg, X, Y, w, device=dev)
    idx = np.stack([rng.choice(n, 1100, replace=False) for _ in range(2)])
    assert TB.route_kernel(cfg, st, 1100, True, True, False) == "epilogue"
    before = TFD.fold_epilogue.launches
    (gx, gy), _ = TB.training_matrices_batched(cfg, st, idx)
    assert TFD.fold_epilogue.launches == before + 1
    (rx, ry), _ = TB.training_matrices_batched(cfg, st, idx, impl="torch")
    torch.cuda.synchronize()
    for a, b in ((gx, rx), (gy, ry)):
        assert (a - b).abs().max().item() <= 1e-12 * b.abs().max().item()


@pytest.mark.parametrize("n_l", [1, 4, 7, 13, 110])
def test_kfold_sweep_probe_matches_cpu(dev, n_l):
    """materialize_cv on the card against the same sweep on the CPU
    (the twins): LOOCV, packed, masked packed, masked v3 and v3."""
    X, Y, w = _data(5)
    keys, idx, mask = T.Partitioner(np.arange(N) % (N // n_l)).padded_batches()
    cfg = T.CVConfig()
    got = TS.materialize_cv(cfg, X, Y, w, idx, mask, batch_size=7,
                            device=dev)
    ref = TS.materialize_cv(cfg, X, Y, w, idx, mask, batch_size=7,
                            device="cpu")
    assert abs(float(got) - float(ref)) <= 1e-10 * abs(float(ref))


# ---- the policy-routed kernels (sym LOOCV, x2 LOOCV, sym v3) ------------- #

NS, KS, MS = 300, 130, 3  # the JAX padded width 256: the sym routes apply


@pytest.fixture
def policy_restored():
    import dataclasses

    before = T.policy()
    yield
    T.set_routing(**dataclasses.asdict(before))


def _counts():
    return {**TFD.launch_counts(), **TL.launch_counts()}


def _sym_data(seed=11):
    rng = np.random.default_rng(seed)
    w = rng.random(NS)
    w[::9] = 0.0
    return rng.normal(size=(NS, KS)) * 2 + 0.5, rng.normal(size=(NS, MS)), w


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("flags", [(True,) * 4, (False,) * 4,
                                   (True, False, False, True),
                                   (False, True, True, False)])
def test_policy_kernels_match_twins(dev, flags, weighted):
    """The sym LOOCV and x2 LOOCV kernels (both dtypes) and the sym v3
    kernel against their twins: float64 at 1e-12 and float32 at 1e-4 of
    the twin's largest entry; the sym X blocks exactly symmetric; x2 bit
    for bit the one-per-block kernel, odd fold counts included."""
    X, Y, w = _sym_data()
    w = w if weighted else None
    rows = np.arange(0, NS, 4)[:75]  # 75 folds: x2 ends on a single fold
    for dtype, rtol in ((np.float64, 1e-12), (np.float32, 1e-4)):
        cfg = T.CVConfig(*flags, dtype=dtype)
        st = T.fit(cfg, X, Y, w, device=dev)
        src = TB.prepare_loocv_sources(cfg, st, rows)
        one = TB.loocv_from_sources(cfg, src, rows, return_XTY=True)
        before = _counts()
        two = TB.loocv_from_sources(cfg, src, rows, return_XTY=True,
                                    two_per_step=True)
        name = "fused_loocv_x2" if dtype == np.float64 else "fused_loocv_f32x2"
        after = _counts()
        assert {k for k in after if after[k] != before[k]} == {name}
        ref = TB.loocv_from_sources(cfg, src, rows, return_XTY=True,
                                    impl="torch")
        torch.cuda.synchronize()
        assert torch.equal(one, two)
        assert (two - ref).abs().max().item() <= rtol * ref.abs().max().item()
        if dtype != np.float64:
            continue
        sym = TB.loocv_from_sources(cfg, src, rows, return_XTY=True,
                                    sym=True)
        ref = TB.loocv_from_sources(cfg, src, rows, return_XTY=True,
                                    sym=True, impl="torch")
        torch.cuda.synchronize()
        assert torch.equal(sym[:, :, :KS], sym[:, :, :KS].mT)
        assert (sym - ref).abs().max().item() <= 1e-12 * ref.abs().max().item()
        idx = np.stack([np.arange(f, NS, 7)[:40] for f in range(5)])
        mask = np.ones(idx.shape)
        mask[::2, -3:] = 0.0
        for m in (None, mask):
            vsrc = TB.prepare_ozaki_sources(cfg, st, idx, m)
            kw = dict(center_xtx=cfg.center_X,
                      center_xty=cfg.center_X or cfg.center_Y,
                      scale_x=cfg.scale_X, scale_y=cfg.scale_Y, with_y=True,
                      resolution=cfg.resolution)
            args = (vsrc.total, vsrc.xw, vsrc.xu, vsrc.yu, vsrc.rows,
                    vsrc.mask, vsrc.gx, vsrc.sxv, vsrc.yvec, vsrc.scal)
            before = _counts()
            got = TFD.fold_v3(*args, **kw, sym=True)
            after = _counts()
            assert {k for k in after if after[k] != before[k]} == {
                "fold_v3_sym"}
            full = TFD.fold_v3(*args, **kw)
            ref = TFD.fold_v3(*args, **kw, sym=True, impl="torch")
            torch.cuda.synchronize()
            assert torch.equal(got[:, :, :KS], got[:, :, :KS].mT)
            assert (got - ref).abs().max().item() <= (
                1e-12 * ref.abs().max().item())
            iu = torch.triu_indices(KS, KS)
            assert torch.equal(got[:, iu[0], iu[1]], full[:, iu[0], iu[1]])


@pytest.mark.parametrize("knobs,dtype,n_l,kernel", [
    (dict(sym_loocv=True), np.float64, 1, "fused_loocv_sym"),
    (dict(sym_loocv=True), np.float64, 10, "fold_v3_sym"),
    (dict(df64x2=True), np.float64, 1, "fused_loocv_x2"),
    (dict(f32x2=True), np.float32, 1, "fused_loocv_f32x2"),
    (dict(sym_loocv=True, df64x2=True), np.float64, 1, "fused_loocv_sym"),
])
def test_set_routing_launches_the_kernel(dev, policy_restored, knobs, dtype,
                                         n_l, kernel):
    """Under each knob the sweep launches its kernel once per chunk and no
    other, and its probe matches the same sweep on the CPU."""
    X, Y, w = _sym_data(12)
    cfg = T.CVConfig(dtype=dtype)
    T.set_routing(**knobs)
    idx = np.arange(NS).reshape(-1, n_l)
    bs, n_chunks = TS.sweep_chunking(cfg, idx.shape[0], KS, KS + MS, 25)
    before = _counts()
    got = TS.materialize_cv(cfg, X, Y, w, idx, batch_size=25)
    after = _counts()
    assert got.device == torch.device("cuda", 0)
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {kernel: n_chunks}
    ref = TS.materialize_cv(cfg, X, Y, w, idx, batch_size=25, device="cpu")
    rtol = 1e-10 if dtype == np.float64 else 1e-4
    assert abs(float(got) - float(ref)) <= rtol * abs(float(ref))


def test_default_device_is_cuda0(dev):
    """fit, CVMatrix and materialize_cv given NumPy inputs and no device
    land on cuda:0."""
    X, Y, w = _data(13)
    cfg = T.CVConfig()
    assert T.fit(cfg, X, Y, w).device == torch.device("cuda", 0)
    assert T.CVMatrix().fit(X, Y, w).state.device == torch.device("cuda", 0)
    probe = TS.materialize_cv(cfg, X, Y, w, np.arange(N)[:, None])
    assert probe.device == torch.device("cuda", 0)


def test_reduce_sweep_on_the_card(dev):
    """cross_validate_reduce through each hoisted loop on the card against
    the same sweep on the CPU (the twins)."""
    X, Y, w = _data(14)
    cfg = T.CVConfig()
    st = T.fit(cfg, X, Y, w, device=dev)
    st_cpu = T.fit(cfg, X, Y, w, device="cpu")

    def red(mats, stats):
        return torch.trace(mats[0]) + mats[1].sum()

    for idx in (np.arange(N)[:, None], np.arange(N).reshape(-1, 4),
                np.arange(N).reshape(-1, 20)):
        got = TS.cross_validate_reduce(cfg, st, idx, reduce_fn=red,
                                       batch_size=32)
        ref = TS.cross_validate_reduce(cfg, st_cpu, idx, reduce_fn=red,
                                       batch_size=32)
        assert got.device.type == "cuda"
        assert (got.cpu() - ref).abs().max().item() <= (
            1e-10 * ref.abs().max().item())


# ---- the small-fold kernel and the mantissa slicer ----------------------- #


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("flags", [(True,) * 4, (False,) * 4,
                                   (True, False, False, True),
                                   (False, True, True, False)])
def test_smallfold_kernel_matches_twin(dev, flags, weighted, masked):
    """The port of fused_smallfold_df64 against its twin, [XTX | XTY] and
    XTX alone, float64 at 1e-12 and float32 at 1e-4 of the twin's largest
    entry, one launch of the dtype's kernel and no other; padded slots
    (index 0, mask 0) add nothing."""
    X, Y, w = _data(15)
    idx = np.stack([np.arange(f, N, 11)[:5] for f in range(9)])
    mask = None
    if masked:
        mask = np.ones(idx.shape)
        mask[::2, -2:] = 0.0
        idx[::2, -2:] = 0
    for dtype, rtol, name in ((np.float64, 1e-12, "fold_smallfold"),
                              (np.float32, 1e-4, "fold_smallfold_f32")):
        cfg = T.CVConfig(*flags, dtype=dtype)
        st = T.fit(cfg, X, Y, w if weighted else None, device=dev)
        for with_y in (True, False):
            src = TB.prepare_loocv_sources(cfg, st, idx, mask,
                                           return_XTY=with_y)
            kw = dict(n_l=idx.shape[1], return_XTY=with_y,
                      has_mask=masked)
            before = _counts()
            got = TB.smallfold_from_sources(cfg, src, idx, **kw)
            after = _counts()
            assert {k: after[k] - before[k] for k in after
                    if after[k] != before[k]} == {name: 1}
            ref = TB.smallfold_from_sources(cfg, src, idx, impl="torch", **kw)
            torch.cuda.synchronize()
            assert got.dtype == ref.dtype == st.X.dtype
            assert (got - ref).abs().max().item() <= (
                rtol * ref.abs().max().item())


@pytest.mark.parametrize("n_slices", [1, 10])
@pytest.mark.parametrize("row_major", [True, False])
def test_slice_rows_kernel_matches_twin(dev, row_major, n_slices):
    """The port of slice_rows bit for bit its twin, one launch, including
    a tie that rounds to even (3.5 -> 4, then -32)."""
    from cvmatrix_tpu_torch.ops import slice_rows as TSR

    rng = np.random.default_rng(16)
    x = rng.normal(size=(512, 96)) * 10.0 ** rng.integers(-6, 6, (1, 96))
    x[:, 0] = rng.normal(size=512) * 0.01  # |x| < 1 at the exponent 0
    x[0, 0] = 3.5 / 64
    e = np.frexp(np.abs(x).max(axis=0).astype(np.float32))[1]
    e[0] = 0
    pows = np.stack([np.ldexp(np.float32(1), np.clip(-e, -127, 127)),
                     np.ldexp(np.float32(1), -e - np.clip(-e, -127, 127))]
                    ).astype(np.float32)
    xh = x.astype(np.float32)
    xl = (x - xh.astype(np.float64)).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (xh, xl, pows)]
    before = TSR.slice_rows.launches
    got = TSR.slice_rows(*args, n_slices=n_slices, row_major=row_major)
    assert TSR.slice_rows.launches == before + 1
    ref = TSR.slice_rows(*args, n_slices=n_slices, row_major=row_major,
                         impl="torch")
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and torch.equal(got, ref)
    first = got[0, :, 0] if row_major else got[:, 0, 0]
    assert first[:2].tolist() == ([4, -32] if n_slices > 1 else [4])


# ---- the tensor-core tile: fold_ozaki_df64 and fold_v3 ------------------- #

N_TILE = 1_200  # the edge cases gather up to 1,003 rows a fold
TILE_L = (1, 3, 10, 17, 100, 1003)


def _tile_fold_batches(rng, n_l):
    """(rows, mask) pairs of one fold size: unmasked and masked, one fold
    where L is 3 or 1,003, else four."""
    f = 1 if n_l in (3, 1003) else 4
    idx = np.stack([rng.choice(N_TILE, n_l, replace=False) for _ in range(f)])
    mask = np.ones(idx.shape)
    mask[::2, -max(1, n_l // 10):] = 0.0
    return (idx, None), (idx, mask)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("flags", list(itertools.product([True, False],
                                                         repeat=4)))
def test_tensor_core_tile_matches_twins(dev, flags, weighted):
    """fold_ozaki_df64 and fold_v3 (the gathered float64 tile on the FP64
    tensor cores) against their twins at 1e-12 of the twin's largest entry,
    one launch of the wrapper's counter each, over the tile's edges: L in
    1, 3, 10, 17, 100 and 1,003; K=40, M=6 (16-byte copies and stores) and
    K=37 with M=0 (8-byte ones, XTX alone); XTY alone (with_x=False); one
    fold and four; masked and unmasked."""
    rng = np.random.default_rng(17)
    cfg = T.CVConfig(*flags)
    for k, m, xtx in ((40, 6, True), (37, 0, True), (40, 6, False)):
        X = rng.random((N_TILE, k))
        Y = rng.random((N_TILE, m)) if m else None
        w = rng.random(N_TILE) if weighted else None
        st = T.fit(cfg, X, Y, w, device=dev)
        xty = m > 0
        total = TB._total(st, xtx, xty)
        xw = st.X if st.weights is None else st.WX
        for n_l in TILE_L:
            for idx, mask in _tile_fold_batches(rng, n_l):
                rows, mask_d = TB._rows_mask(cfg, st, idx, mask)
                stats5 = TB._summed_stats(cfg, st, rows, mask_d,
                                          **TB._stat_flags(cfg, xtx, xty))
                kvec, cvec = TB._reference_vectors(
                    cfg, st, stats5, st.X.new_empty((idx.shape[0], 0)), xtx,
                    xty)
                args = (total, xw, st.X, st.Y if xty else None, rows, mask_d,
                        kvec, cvec)
                runs = [("fold_ozaki_df64", lambda impl: TFD.fold_ozaki_df64(
                    *args, with_x=xtx, impl=impl))]
                if xtx:
                    src = TB.prepare_ozaki_sources(cfg, st, idx, mask,
                                                   return_XTY=xty)
                    runs.append(("fold_v3", lambda impl: (
                        TB.ozaki_v3_from_sources(cfg, src, return_XTY=xty,
                                                 impl=impl))))
                for name, run in runs:
                    before = TFD.launch_counts()
                    got = run("cuda")
                    after = TFD.launch_counts()
                    assert {n: after[n] - before[n] for n in after
                            if after[n] != before[n]} == {name: 1}
                    ref = run("torch")
                    torch.cuda.synchronize()
                    assert got.shape == ref.shape == (
                        idx.shape[0], k, (k if xtx else 0) + m)
                    assert (got - ref).abs().max().item() <= (
                        1e-12 * ref.abs().max().item()), (name, k, m, xtx,
                                                          n_l, mask is None)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k,m", [(130, 3), (37, 0), (40, 6)])
def test_sym_v3_tensor_core_tile(dev, k, m, masked):
    """fold_v3(sym=True) on the tensor-core tile: one launch of its counter,
    the X block exactly symmetric, the upper triangle and the XTY columns
    bit-equal to the full tile's, within 1e-12 of the twin's largest entry;
    ragged K (8-byte copies at K=130, M=3 and K=37, M=0; 16-byte ones at
    K=40, M=6, where pairs straddle the diagonal), L from 1 to 103."""
    rng = np.random.default_rng(21)
    X = rng.normal(size=(N_TILE, k)) * 2 + 0.5
    Y = rng.normal(size=(N_TILE, m)) if m else None
    w = rng.random(N_TILE)
    for flags in ((True,) * 4, (False,) * 4, (True, False, False, True)):
        cfg = T.CVConfig(*flags)
        st = T.fit(cfg, X, Y, w, device=dev)
        for n_l in (1, 10, 40, 103):
            idx = np.stack([rng.choice(N_TILE, n_l, replace=False)
                            for _ in range(3)])
            mask = None
            if masked:
                mask = np.ones(idx.shape)
                mask[::2, -max(1, n_l // 10):] = 0.0
            src = TB.prepare_ozaki_sources(cfg, st, idx, mask,
                                           return_XTY=m > 0)
            args = (src.total, src.xw, src.xu, src.yu, src.rows, src.mask,
                    src.gx, src.sxv, src.yvec, src.scal)
            kw = dict(center_xtx=cfg.center_X,
                      center_xty=cfg.center_X or cfg.center_Y,
                      scale_x=cfg.scale_X, scale_y=cfg.scale_Y, with_y=m > 0,
                      resolution=cfg.resolution)
            before = TFD.launch_counts()
            got = TFD.fold_v3(*args, **kw, sym=True)
            after = TFD.launch_counts()
            assert {n: after[n] - before[n] for n in after
                    if after[n] != before[n]} == {"fold_v3_sym": 1}
            full = TFD.fold_v3(*args, **kw)
            ref = TFD.fold_v3(*args, **kw, sym=True, impl="torch")
            torch.cuda.synchronize()
            x = got[:, :, :k]
            assert torch.equal(x, x.mT)
            iu = torch.triu_indices(k, k, device=dev)
            assert torch.equal(got[:, iu[0], iu[1]], full[:, iu[0], iu[1]])
            assert torch.equal(got[:, :, k:], full[:, :, k:])
            assert (got - ref).abs().max().item() <= (
                1e-12 * ref.abs().max().item()), (flags, n_l)


# (folds, rows, K, C): split across blocks, and not
F32_TILE_CASES = [(3, 33_334, 500, 510), (1, 4_000, 130, 133),
                  (2, 2_000, 48, 52), (8, 100, 130, 133), (6, 32, 500, 510),
                  (5, 77, 37, 43)]


@pytest.mark.parametrize("f,n_l,k,c", F32_TILE_CASES)
def test_downdate_f32_stream_tile(dev, f, n_l, k, c):
    """fold_downdate_f32 on the float32 stream tile, split and unsplit as
    downdate_f32_splits says, masked rows and not: within 1e-4 of the
    twin's largest entry, one launch a call, the same bits from a second
    call."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = TFD.downdate_f32_splits(f, k, c, n_l, n_sm)
    assert (splits > 1) == (n_l >= 2_000), splits
    rng = np.random.default_rng(22)
    ops = [torch.from_numpy(rng.random(s, dtype=np.float32)).to(dev)
           for s in ((k, c), (f, n_l, k), (f, n_l, c), (f, 2, k), (f, 2, c))]
    ops[0] *= n_l
    for masked in (False, True):
        if masked:
            ops[1][::2, -max(1, n_l // 10):] = 0.0
        got = []
        for _ in range(2):
            before = TFD.fold_downdate_f32.launches
            got.append(TFD.fold_downdate_f32(*ops))
            assert TFD.fold_downdate_f32.launches == before + 1
        ref = TFD.fold_downdate_f32(*ops, impl="torch")
        torch.cuda.synchronize()
        assert torch.equal(got[0], got[1])
        assert (got[0] - ref).abs().max().item() <= (
            1e-4 * ref.abs().max().item())


# ---- fold rows and masks on the card ------------------------------------- #


@pytest.mark.parametrize("n_l", [4, 20, 500])
def test_cuda_mask_matches_numpy_mask(dev, n_l):
    """A CUDA mask_batch through training_matrices_batched and
    materialize_cv gives the NumPy mask's result bit for bit and launches
    the same kernel (packed, v3, Ozaki-df64)."""
    rng = np.random.default_rng(18)
    X, Y = rng.random((N_ROUTES, K)), rng.random((N_ROUTES, M))
    w = rng.random(N_ROUTES)
    cfg = T.CVConfig()
    st = T.fit(cfg, X, Y, w, device=dev)
    idx = _folds(n_l, 5, n_l)
    mask = np.ones(idx.shape)
    mask[::2, -2:] = 0.0
    results = {}
    for name, m in (("numpy", mask), ("cuda", torch.from_numpy(mask).to(dev))):
        before = TFD.launch_counts()
        mats, _ = TB.training_matrices_batched(cfg, st, idx, m)
        probe = TS.materialize_cv(cfg, X, Y, w, idx, m, batch_size=2,
                                  device=dev)
        after = TFD.launch_counts()
        results[name] = (torch.cat(mats, 2), probe,
                         {n: after[n] - before[n] for n in after
                          if after[n] != before[n]})
    (a, pa, la), (b, pb, lb) = results["numpy"], results["cuda"]
    assert la == lb and len(la) == 1, (la, lb)
    assert torch.equal(a, b) and torch.equal(pa, pb)


def test_cuda_rows_outside_raise_before_launch(dev):
    """CUDA (F, L) fold rows holding N raise ValueError from
    prepare_fold_operands, prepare_ozaki_sources and
    smallfold_from_sources before any kernel launches."""
    X, Y, w = _data(19)
    cfg = T.CVConfig()
    st = T.fit(cfg, X, Y, w, device=dev)
    idx = np.arange(12).reshape(3, 4)
    src = TB.prepare_loocv_sources(cfg, st, idx)
    bad = torch.from_numpy(idx).to(dev)
    bad[1, 2] = N
    before = _counts()
    for call in (lambda: TB.prepare_fold_operands(cfg, st, bad),
                 lambda: TB.prepare_ozaki_sources(cfg, st, bad),
                 lambda: TB.smallfold_from_sources(
                     cfg, src, bad, n_l=4, return_XTY=True,
                     has_mask=False)):
        with pytest.raises(ValueError, match="outside"):
            call()
    torch.cuda.synchronize()
    assert _counts() == before
    # in range, the same CUDA rows run
    bad[1, 2] = 5
    TB.smallfold_from_sources(cfg, src, bad, n_l=4, return_XTY=True,
                              has_mask=False)
    assert _counts()["fold_smallfold"] == before["fold_smallfold"] + 1


def test_smallfold_checks_cuda_rows_once_per_sources(dev, monkeypatch):
    """Sources built from CUDA rows check them once; smallfold_from_sources
    on slices of ``src.rows`` checks nothing more (no sync a chunk), while
    other CUDA rows are checked at each call."""
    X, Y, w = _data(20)
    cfg = T.CVConfig()
    st = T.fit(cfg, X, Y, w, device=dev)
    idx = torch.arange(24, device=dev).reshape(6, 4)
    checks = []
    real = TB._loocv.check_rows

    def counting(rows, n):
        checks.append(torch.as_tensor(rows).device.type)
        return real(rows, n)

    monkeypatch.setattr(TB._loocv, "check_rows", counting)
    src = TB.prepare_loocv_sources(cfg, st, idx)
    assert checks == ["cuda"] and src.rows.device.type == "cuda"
    assert src.rows.data_ptr() != idx.data_ptr()
    kw = dict(n_l=4, return_XTY=True, has_mask=False)
    before = _counts()["fold_smallfold"]
    got = [TB.smallfold_from_sources(cfg, src, src.rows[sl], src.scal[sl],
                                     **kw) for sl in (slice(0, 2),
                                                      slice(2, 6))]
    assert checks == ["cuda"]
    assert _counts()["fold_smallfold"] == before + 2
    ref = TB.smallfold_from_sources(cfg, src, idx.clone(), **kw)
    assert checks == ["cuda", "cuda"]
    assert torch.equal(torch.cat(got), ref)


# ---- the row-stream tile: fold_packed and fold_smallfold ------------------ #

ROW_L = (1, 2, 3, 4, 9, 17, 31)
ROW_F = (1, 67)
N_ROW = 1_200


def _row_check(got, ref, dtype):
    """Within 1e-12 (float64) or 1e-4 (float32) of the twin's largest
    entry: float64 sums in another order by a few ulps, float32 ones by
    the JAX package's f32 interpret bound."""
    rtol = 1e-12 if dtype == torch.float64 else 1e-4
    assert got.dtype == ref.dtype == dtype
    assert (got - ref).abs().max().item() <= rtol * ref.abs().max().item()


def _one_launch(counter, run):
    before = TFD.launch_counts()
    got = run()
    after = TFD.launch_counts()
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {counter: 1}
    return got


@pytest.mark.parametrize("n_l", ROW_L)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rowstream_tile_packed(dev, dtype, n_l):
    """fold_packed on the row-stream tile against its twin: [XTX | XTY] at
    K=37, M=3 and at K=500, M=10, XTX alone (K=37) and XTY alone (C=3);
    one fold and 67; rows masked out of u and not; operands and out as
    fold-offset views of a larger batch (float32 views at odd L K, L C and
    K C offsets take narrower stores) and not; one launch a call, and a
    second call bit-equal to the first."""
    counter = "fold_packed" if dtype == torch.float64 else "fold_packed_f32"
    rng = np.random.default_rng(30 + n_l)
    for (k, c), f, masked, view in itertools.product(
            ((37, 40), (37, 37), (37, 3), (500, 510)), ROW_F, (False, True),
            (False, True)):
        g = f + view  # a view drops the batch's first fold

        def t(*shape):
            return torch.from_numpy(rng.random(shape)).to(dev, dtype)

        total, u, v, kvec, cvec = (t(k, c) * n_l, t(g, n_l, k), t(g, n_l, c),
                                   t(g, 2, k), t(g, 2, c))
        if masked:
            u[::2, -max(1, n_l // 3):] = 0.0
        out = torch.empty((g, k, c), dtype=dtype, device=dev)
        ops = (total, u[view:], v[view:], kvec[view:], cvec[view:])
        got = _one_launch(counter, lambda: TFD.fold_packed(
            *ops, out=out[view:]))
        assert got.data_ptr() == out[view:].data_ptr()
        again = TFD.fold_packed(*ops)
        ref = TFD.fold_packed(*ops, impl="torch")
        torch.cuda.synchronize()
        assert torch.equal(got, again), (k, c, f, masked, view)
        _row_check(got, ref, dtype)


@pytest.mark.parametrize("n_l", ROW_L)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rowstream_tile_smallfold(dev, dtype, n_l):
    """fold_smallfold (its vector phase, then the row-stream tile's
    gathered reference form) against its twin: K=37 with M=3 and M=0 (one
    element a store) and K=500, M=10; one fold and 67; masked with padded
    slots at index 0 and not; rows, scalars, mask and out as fold-offset
    views and not; one launch a call, and a second call bit-equal."""
    counter = ("fold_smallfold" if dtype == torch.float64
               else "fold_smallfold_f32")
    rng = np.random.default_rng(40 + n_l)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    cfg = T.CVConfig(True, True, True, True, dtype=np_dtype)
    for (k, m), f, masked, view in itertools.product(
            ((37, 3), (37, 0), (500, 10)), ROW_F, (False, True),
            (False, True)):
        X = rng.random((N_ROW, k))
        Y = rng.random((N_ROW, m)) if m else None
        st = T.fit(cfg, X, Y, rng.random(N_ROW), device=dev)
        g = f + view
        idx = rng.integers(0, N_ROW, (g, n_l))
        mask = None
        if masked:
            mask = np.ones(idx.shape)
            mask[::2, -max(1, n_l // 3):] = 0.0
            idx[mask == 0] = 0  # padded slots
        src = TB.prepare_loocv_sources(cfg, st, idx, mask, return_XTY=m > 0)
        out = torch.empty((g, k, k + m), dtype=dtype, device=dev)
        kw = dict(n_l=n_l, return_XTY=m > 0, has_mask=masked)
        args = (src.rows[view:], src.scal[view:],
                None if mask is None else src.mask[view:])
        got = _one_launch(counter, lambda: TB.smallfold_from_sources(
            cfg, src, *args, out=out[view:], **kw))
        assert got.data_ptr() == out[view:].data_ptr()
        again = TB.smallfold_from_sources(cfg, src, *args, **kw)
        ref = TB.smallfold_from_sources(cfg, src, *args, impl="torch", **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, again), (k, m, f, masked, view)
        _row_check(got, ref, dtype)


# ---- the epilogue's column-stationary stream and the vector slicer ------- #

# (K, C) of the epilogue's edges: C = K (M = 0, or XTX alone), K + 1 (odd,
# M = 1), K + 10 and M alone (XTY alone), at K = 37 (not a multiple of any
# row band) and K = 500; C = 1,031 takes three column strips, odd.
EPILOGUE_KC = ((37, 37), (37, 38), (37, 47), (37, 1), (37, 10), (500, 500),
               (500, 501), (500, 510), (130, 1031))


@pytest.mark.parametrize("f", ROW_F)
@pytest.mark.parametrize("k,c", EPILOGUE_KC)
def test_epilogue_kernel_edges(dev, k, c, f):
    """fold_epilogue against its twin within 1e-12 of the twin's largest
    entry, in place, with prod a fold-offset view of a larger buffer (its
    rows then start 8 bytes off a 16-byte boundary where C is odd) and
    not; one launch a call, a second call on a copy of the same product
    bit-equal to the first, and the fold before the view untouched."""
    rng = np.random.default_rng(60 + k + c + f)
    for view in (False, True):
        g = f + view

        def t(*shape):
            return torch.from_numpy(rng.random(shape)).to(dev)

        total, prod, kvec, cvec = t(k, c), t(g, k, c), t(g, 2, k), t(g, 2, c)
        vecs = (kvec[view:], cvec[view:])
        a, b = prod.clone(), prod.clone()
        got = _one_launch("fold_epilogue", lambda: TFD.fold_epilogue(
            total, a[view:], *vecs))
        assert got.data_ptr() == a[view:].data_ptr()
        TFD.fold_epilogue(total, b[view:], *vecs)
        ref = TFD.epilogue_reference(total, prod[view:], *vecs)
        torch.cuda.synchronize()
        assert torch.equal(a, b), (k, c, f, view)
        assert torch.equal(a[:view], prod[:view])
        assert (got - ref).abs().max().item() <= (
            1e-12 * ref.abs().max().item()), (k, c, f, view)


def test_epilogue_route_at_wide_k(dev):
    """K = 1,100, M = 1 (C odd, padded width over 512) through
    training_matrices_batched: the bmm + epilogue route, one epilogue
    launch, within 1e-12 of the twin route's largest entry."""
    rng = np.random.default_rng(61)
    n, k = 600, 1100
    X, Y, w = rng.random((n, k)), rng.random((n, 1)), rng.random(n)
    cfg = T.CVConfig(True, True, True, True, ddof=1)
    st = T.fit(cfg, X, Y, w, device=dev)
    idx = np.arange(n).reshape(3, 200)
    assert TB.route_kernel(cfg, st, 200, True, True, False) == "epilogue"
    (gx, gy), _ = _one_launch("fold_epilogue", lambda: (
        TB.training_matrices_batched(cfg, st, idx)))
    (rx, ry), _ = TB.training_matrices_batched(cfg, st, idx, impl="torch")
    torch.cuda.synchronize()
    for a, b in ((gx, rx), (gy, ry)):
        assert (a - b).abs().max().item() <= 1e-12 * b.abs().max().item()


def _offset_plane(a, dev):
    """``a`` as a contiguous float32 view 4 bytes into a larger buffer, so
    that no row starts 16-byte aligned."""
    buf = torch.empty(a.size + 1, dtype=torch.float32, device=dev)
    view = buf[1:].view(a.shape)
    view.copy_(torch.from_numpy(a))
    return view


@pytest.mark.parametrize("row_major", [True, False])
@pytest.mark.parametrize("k", [1, 3, 500, 501])
def test_slice_rows_kernel_edges(dev, k, row_major):
    """The slicer bit for bit its twin at K = 1, 3, 500 (the vector path)
    and 501 (ragged), N = 1 and 40, the planes contiguous and as offset
    views (the scalar path); one launch a call and a second call
    bit-equal to the first."""
    from cvmatrix_tpu_torch.ops import slice_rows as TSR

    rng = np.random.default_rng(70 + k)
    for n, view in itertools.product((1, 40), (False, True)):
        x = rng.normal(size=(n, k)) * 10.0 ** rng.integers(-6, 6, (1, k))
        e = np.frexp(np.abs(x).max(axis=0).astype(np.float32))[1]
        h1 = np.clip(-e, -127, 127)
        pows = torch.from_numpy(np.stack([
            np.ldexp(np.float32(1), h1), np.ldexp(np.float32(1), -e - h1),
        ]).astype(np.float32)).to(dev)
        xh = x.astype(np.float32)
        xl = (x - xh.astype(np.float64)).astype(np.float32)
        if view:
            xh, xl = _offset_plane(xh, dev), _offset_plane(xl, dev)
        else:
            xh, xl = (torch.from_numpy(a).to(dev) for a in (xh, xl))
        kw = dict(n_slices=10, row_major=row_major, block_rows=n)
        before = TSR.slice_rows.launches
        got = TSR.slice_rows(xh, xl, pows, **kw)
        assert TSR.slice_rows.launches == before + 1
        again = TSR.slice_rows(xh, xl, pows, **kw)
        ref = TSR.slice_rows(xh, xl, pows, impl="torch", **kw)
        torch.cuda.synchronize()
        assert got.dtype == torch.int8
        assert torch.equal(got, ref), (k, n, view, row_major)
        assert torch.equal(got, again)


def test_spans_share_the_clock_with_the_loocv_kernel(dev, tmp_path):
    """Two profiled LOOCV chunks at K=500, the first of 8,000 folds (a
    kernel of about 7 ms), the second of 980: each LOOCV kernel starts on
    the card after its chunk's route span starts, each chunk copies its
    rows once, and the second chunk's copy, which waits for no stream,
    ends while the first chunk's kernel still runs."""
    import json

    from cvmatrix_tpu_torch.utils import profiling as P

    rng = np.random.default_rng(3)
    n, k, m = 20_000, 500, 10
    X, Y, w = (torch.from_numpy(rng.random(s)).to(dev)
               for s in ((n, k), (n, m), (n, 1)))
    cfg = T.CVConfig(True, True, True, True, ddof=1)
    st = T.fit(cfg, X, Y, w)
    perm = rng.permutation(n)
    chunks = perm[:8000, None], perm[8000:8980, None]
    for idx in chunks:  # loads the kernel, caches the outputs' memory
        TB.training_matrices_batched(cfg, st, idx)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for idx in chunks:
            TB.training_matrices_batched(cfg, st, idx)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]

    def spans(cat, pick):
        return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in events
                      if e.get("cat") == cat and pick(e.get("name", "")))

    route = spans("user_annotation", lambda s: s == P.ROUTE + "loocv")
    h2d = spans("user_annotation", lambda s: s == P.H2D)
    kernel = spans("kernel", lambda s: "loocv_tile_kernel" in s)
    # one copy a chunk: the sources' rows, which the kernel reads
    assert len(route) == 2 and len(kernel) == 2 and len(h2d) == 2
    assert all(r0 <= k0 for (r0, _), (k0, _) in zip(route, kernel))
    assert h2d[1][1] < kernel[0][1]


def _route_case(dev, route, masked=False):
    """``(cfg, state, idx, mask)`` on the card whose batch takes ``route``
    of the cells' routes: one-row LOOCV folds, 12-row v3 folds, or 40-row
    folds on the epilogue (``matmul_mode="native"``)."""
    X, Y, w = _data(30)
    n_l, mode = {"loocv": (1, "auto"), "v3": (12, "auto"),
                 "epilogue": (40, "native")}[route]
    cfg = T.CVConfig(True, True, True, True, ddof=1, matmul_mode=mode)
    st = T.fit(cfg, X, Y, w, device=dev)
    n_folds = N // n_l
    idx = np.random.default_rng(31).permutation(N)[:n_folds * n_l].reshape(
        n_folds, n_l)
    mask = None
    if masked:
        mask = np.ones((n_folds, n_l))
        mask[:, -1] = 0.0
    assert TB.route_kernel(cfg, st, n_l, True, True, masked,
                           n_folds=n_folds) == route
    return cfg, st, idx, mask


@pytest.mark.parametrize("route,masked", [
    ("loocv", False), ("v3", False), ("v3", True), ("epilogue", False),
    ("epilogue", True)])
def test_batched_entry_makes_no_sync(dev, route, masked):
    """After a warm-up, ``training_matrices_batched`` on host rows (and a
    host mask) makes no synchronising CUDA call on the routes the cells
    run: under ``set_sync_debug_mode("error")`` a blocking copy, an
    ``item()`` or a stream synchronisation would raise."""
    cfg, st, idx, mask = _route_case(dev, route, masked)
    TB.training_matrices_batched(cfg, st, idx, mask)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            TB.training_matrices_batched(cfg, st, idx, mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("route", ["loocv", "v3", "epilogue"])
def test_batched_entry_copies_the_callers_rows(dev, route, pinned):
    """The caller's rows (and mask), overwritten as soon as the call
    returns while the card is still busy with earlier work, do not reach
    the outputs: each call copies them before it returns, also where the
    caller's memory is pinned already."""
    cfg, st, idx, mask = _route_case(dev, route, masked=route != "loocv")
    want = TB.training_matrices_batched(cfg, st, idx, mask)
    torch.cuda.synchronize()
    rows = torch.from_numpy(idx.copy())
    held = None if mask is None else torch.from_numpy(mask.copy())
    if pinned:
        rows = rows.pin_memory()
        held = None if held is None else held.pin_memory()
    big = torch.rand((4096, 4096), dtype=torch.float64, device=dev)
    for _ in range(8):  # keeps the card busy while the host runs on
        big = big @ big
        big /= big.abs().max()
    got = TB.training_matrices_batched(cfg, st, rows, held)
    rows.copy_(rows.flip(0))
    if held is not None:
        held.fill_(1.0)
    torch.cuda.synchronize()
    for a, b in zip(pytree.tree_leaves(want), pytree.tree_leaves(got)):
        assert torch.equal(a, b)


# ---- the training statistics the LOOCV kernels store ---------------------- #


@pytest.mark.parametrize("with_y", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("flags", [(True,) * 4, (False,) * 4,
                                   (True, False, False, True),
                                   (False, True, True, False)])
def test_loocv_kernels_store_the_twins_stats(dev, flags, weighted, with_y):
    """Each LOOCV kernel (one and two folds a block, float64 and float32;
    the symmetric one, float64) stores the twin's statistics, at 1e-12 of
    each statistic's largest entry in float64 and 1e-5 in float32, ``None``
    in the same places; its matrices are those of the same launch without
    statistics, bit for bit; ``launches_stats`` moves by one a launch that
    stores them, and by none otherwise."""
    X, Y, w = _sym_data(17)
    rows = np.arange(0, NS, 4)[:75]  # 75 folds: x2 ends on a single fold
    for dtype, rtol in ((np.float64, 1e-12), (np.float32, 1e-5)):
        cfg = T.CVConfig(*flags, dtype=dtype)
        st = T.fit(cfg, X, Y if with_y else None, w if weighted else None,
                   device=dev)
        src = TB.prepare_loocv_sources(cfg, st, rows, return_XTY=with_y)
        _, ref = TB.loocv_from_sources(cfg, src, rows, return_XTY=with_y,
                                       impl="torch", return_stats=True)
        kinds = [{}, dict(two_per_step=True)]
        if dtype == np.float64:
            kinds.append(dict(sym=True))
        for kw in kinds:
            before = TL.fused_loocv.launches_stats
            plain = TB.loocv_from_sources(cfg, src, rows, return_XTY=with_y,
                                          **kw)
            assert TL.fused_loocv.launches_stats == before
            out, stats = TB.loocv_from_sources(
                cfg, src, rows, return_XTY=with_y, return_stats=True, **kw)
            assert TL.fused_loocv.launches_stats == before + 1
            torch.cuda.synchronize()
            assert torch.equal(out, plain), kw
            for got, want in zip(stats, ref):
                assert (got is None) == (want is None)
                if got is None:
                    continue
                assert got.dtype == want.dtype and got.shape == want.shape
                assert got.device == want.device == out.device
                err = (got - want).abs().max().item()
                assert err <= rtol * want.abs().max().item(), (kw, err)


@pytest.mark.parametrize("knobs,kernel", [
    ({}, "fused_loocv"),
    (dict(df64x2=True), "fused_loocv_x2"),
    (dict(sym_loocv=True), "fused_loocv_sym"),
])
def test_launches_stats_one_a_chunk_on_the_loocv_routes(
        dev, policy_restored, knobs, kernel):
    """``fused_loocv_stats`` counts one a chunk where a LOOCV route returns
    the statistics (``training_matrices_batched`` and the hoisted LOOCV
    reduce loop), none in ``materialize_sweep`` and on the mesh path's
    blocks; the reduce sweep, whose reduction reads the statistics, matches
    the same sweep on the CPU."""
    from cvmatrix_tpu_torch.core.fold import gather_val_blocks

    X, Y, w = _sym_data(18)
    cfg = T.CVConfig()
    st = T.fit(cfg, X, Y, w, device=dev)
    T.set_routing(**knobs)
    idx = np.arange(NS)[:, None]

    def moved(run):
        before = _counts()
        res = run()
        after = _counts()
        return res, {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}

    def red(mats, stats):
        return (torch.trace(mats[0]) + mats[1].sum()
                + sum(s.sum() for s in stats))

    _, n = moved(lambda: TB.training_matrices_batched(cfg, st, idx[:50]))
    assert n == {kernel: 1, "fused_loocv_stats": 1}
    got, n = moved(lambda: TS.cross_validate_reduce(
        cfg, st, idx, reduce_fn=red, batch_size=30))
    assert n == {kernel: 10, "fused_loocv_stats": 10}
    ref = TS.cross_validate_reduce(cfg, T.fit(cfg, X, Y, w, device="cpu"),
                                   idx, reduce_fn=red, batch_size=30)
    assert (got.cpu() - ref).abs().max().item() <= (
        1e-10 * ref.abs().max().item())
    _, n_chunks = TS.sweep_chunking(cfg, NS, KS, KS + MS, 30)
    _, n = moved(lambda: TS.materialize_sweep(cfg, st, idx, batch_size=30))
    assert n == {kernel: n_chunks}
    blocks = gather_val_blocks(cfg, st, torch.arange(50, device=dev)[:, None],
                               None, True)
    _, n = moved(lambda: TB.batched_matrices_from_blocks(cfg, st, blocks))
    assert n == {kernel: 1}
