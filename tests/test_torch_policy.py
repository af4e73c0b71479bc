"""The port's routing policy against the JAX package's.

``cvmatrix_tpu_torch.policy`` is a copy of ``cvmatrix_tpu.policy``: the
same fields and defaults, ``set_routing`` with the same errors, and a
``route_kernel`` that names, for every knob set, dtype, geometry and fold
size, the kernel the JAX gates and accessors pick. Each package keeps its
own policy; the fixture restores both. The materialising sweeps are held
with each knob on against the knob-off sweep, the JAX sweep under the same
``set_routing`` and the per-fold engine (the twins run on the CPU).
"""

import dataclasses
import os
import subprocess
import sys
from itertools import product

import numpy as np
import pytest
from numpy.testing import assert_allclose

import cvmatrix_tpu as J
import cvmatrix_tpu_torch as T
from cvmatrix_tpu.core import batch as JB
from cvmatrix_tpu.models import sweep as JS
from cvmatrix_tpu.ops import kernels as JK
from cvmatrix_tpu_torch.core import batch as TB
from cvmatrix_tpu_torch.models import sweep as TS

KNOBS = ("sym_loocv", "df64x2", "f32x2")


@pytest.fixture(autouse=True)
def _restore_policies():
    before = (J.policy(), T.policy())
    yield
    J.set_routing(**dataclasses.asdict(before[0]))
    T.set_routing(**dataclasses.asdict(before[1]))


def test_fields_and_defaults_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(J.RoutingPolicy)]
    tf = [(f.name, f.default) for f in dataclasses.fields(T.RoutingPolicy)]
    assert tf == jf
    assert T.RoutingPolicy() == T.policy()  # no override in the test env
    assert T.policy() == T.RoutingPolicy(**dataclasses.asdict(J.policy()))


def test_set_routing_replaces_and_rejects_unknown_names():
    new = T.set_routing(sym_loocv=True, f32x2=True)
    assert new is T.policy() and new.sym_loocv and new.f32x2
    T.set_routing(sym_loocv=False)
    assert T.policy().f32x2  # a partial update leaves the others alone
    with pytest.raises(TypeError):
        T.set_routing(not_a_knob=True)
    with pytest.raises(TypeError):
        J.set_routing(not_a_knob=True)


def test_packages_keep_separate_policies():
    T.set_routing(sym_loocv=True, hoist_reduce=False)
    assert not J.policy().sym_loocv and J.policy().hoist_reduce
    J.set_routing(df64x2=True)
    assert not T.policy().df64x2 and T.policy().sym_loocv


def test_environment_overrides_read_at_import():
    env = dict(os.environ, CVMATRIX_TPU_SYM_LOOCV="1", CVMATRIX_TPU_F32X2="0",
               CVMATRIX_TPU_OZAKI_BUDGET_LOG2="-36")
    out = subprocess.run(
        [sys.executable, "-c",
         "import cvmatrix_tpu_torch as T; p = T.policy(); "
         "print(p.sym_loocv, p.f32x2, p.ozaki_budget_log2)"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.split() == ["True", "False", "-36"]


def test_ozaki_budget_flows_from_policy():
    """The v3 trim groups follow ``ozaki_budget_log2`` in both packages."""
    for budget in (-36, -31, -26):
        T.set_routing(ozaki_budget_log2=budget)
        J.set_routing(ozaki_budget_log2=budget)
        for n_l in (10, 32, 100, 400):
            assert TB.ozaki_trim_groups(n_l) == JK.ozaki_trim_groups(n_l)
    T.set_routing(ozaki_budget_log2=-36)
    assert TB.ozaki_trim_groups(32) > TB.ozaki_trim_groups(32,
                                                           budget_log2=-31)


def test_sym_tile_matches_jax():
    for kp in (128, 256, 384, 512, 640, 768, 1024):
        assert TB.loocv_sym_tile(kp) == JB.loocv_sym_tile(kp)


def _states(k, m, dtype):
    x = np.zeros((3, k), dtype)
    y = np.zeros((3, m), dtype)
    flags = (False, False, False, False)
    jcfg = J.CVConfig(*flags, dtype=dtype)
    js = J.fit(jcfg, x, y)
    st = T.FitState.from_numpy({f: None if getattr(js, f) is None
                                else np.asarray(getattr(js, f))
                                for f in js.__dataclass_fields__})
    return jcfg, js, T.CVConfig(*flags, dtype=dtype), st


def jax_policy_route(cfg, js, n_l, n_folds):
    """The kernel the JAX package runs for an unmasked [XTX | XTY] batch:
    its sweeps' LOOCV choice (models/sweep.py:625-646, :352-375) and v3
    switch (core/batch.py:1656-1664), read through its accessors."""
    is_f64 = np.dtype(cfg.dtype).itemsize == 8
    kp = JB._round_up(max(js.K, 8), 128)
    sym = JB._sym_enabled() and JB.loocv_sym_tile(kp) is not None
    if n_l == 1 and JB.loocv_single_tile_ok(cfg, js, True, True):
        if is_f64 and sym:
            return "loocv_sym"
        x2 = JB._df64x2_enabled() if is_f64 else JB._f32x2_enabled()
        return "loocv_x2" if x2 and n_folds % 2 == 0 else "loocv"
    if not is_f64:
        return ("downdate_f32" if n_l >= JB.LARGE_FOLD_ROWS
                else "packed_f32")
    threshold = JB.large_fold_threshold(cfg, js, True, True)
    if n_l < threshold:
        return "packed"
    if JB.ozaki_v3_ok(cfg, js, True, True, n_l):
        return "v3_sym" if sym else "v3"
    return "ozaki_df64"


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("k,m", [(6, 2), (130, 3)])
def test_route_kernel_matches_jax_under_every_knob_set(k, m, dtype):
    """Every subset of the three knobs x {K+M <= 128, K+M >= 129} x L in
    {1, 4, 10, 100} x an even and an odd fold count."""
    jcfg, js, cfg, st = _states(k, m, dtype)
    seen = set()
    for on in product([False, True], repeat=len(KNOBS)):
        knobs = dict(zip(KNOBS, on))
        J.set_routing(**knobs)
        T.set_routing(**knobs)
        for n_l, n_folds in product((1, 4, 10, 100), (6, 7)):
            got = TB.route_kernel(cfg, st, n_l, True, True, False,
                                  n_folds=n_folds)
            assert got == jax_policy_route(jcfg, js, n_l, n_folds), (
                knobs, n_l, n_folds)
            assert got in TB.TPU_KERNELS
            seen.add(got)
    expect = {(6, 2, np.float64): {"loocv", "loocv_x2", "packed", "v3"},
              (130, 3, np.float64): {"loocv", "loocv_x2", "loocv_sym",
                                     "packed", "v3", "v3_sym"},
              (6, 2, np.float32): {"loocv", "loocv_x2", "packed_f32",
                                   "downdate_f32"},
              (130, 3, np.float32): {"loocv", "loocv_x2", "packed_f32",
                                     "downdate_f32"}}
    assert seen == expect[(k, m, dtype)]


def test_route_names_the_ported_kernels():
    _, _, cfg, st = _states(130, 3, np.float64)
    T.set_routing(sym_loocv=True, df64x2=True)
    assert TB.route_kernel(cfg, st, 1, True, True, False) == "loocv_sym"
    assert "fused_loocv_df64_sym " in TB.TPU_KERNELS["loocv_sym"]
    assert TB.route_kernel(cfg, st, 1, True, True, True) == "packed"
    assert "fused_ozaki_downdate_v3_sym " in TB.TPU_KERNELS[
        TB.route_kernel(cfg, st, 10, True, True, True)]
    T.set_routing(sym_loocv=False)
    assert "fused_loocv_df64x2 " in TB.TPU_KERNELS[
        TB.route_kernel(cfg, st, 1, True, True, False)]
    assert "fused_loocv_f32x2 " in TB.TPU_KERNELS["loocv_x2"]
    # an odd fold count keeps one fold per block
    assert TB.route_kernel(cfg, st, 1, True, True, False, n_folds=5) == (
        "loocv")


# ---- the materialising sweeps under each knob --------------------------- #

N, K, M = 300, 130, 3
_rng = np.random.default_rng(21)
X_S = _rng.normal(size=(N, K)) * 2 + 0.5
Y_S = _rng.normal(size=(N, M))
W_S = _rng.uniform(0, 2, size=N)
W_S[::11] = 0.0


# name: (knobs, dtype, fold rows, the port's route)
SWEEP_CASES = {
    "sym_loocv": (dict(sym_loocv=True), np.float64, 1, "loocv_sym"),
    "sym_v3": (dict(sym_loocv=True), np.float64, 10, "v3_sym"),
    "df64x2": (dict(df64x2=True), np.float64, 1, "loocv_x2"),
    "f32x2": (dict(f32x2=True), np.float32, 1, "loocv_x2"),
    "sym_and_df64x2": (dict(sym_loocv=True, df64x2=True), np.float64, 1,
                       "loocv_sym"),
}


@pytest.mark.parametrize("case", sorted(SWEEP_CASES))
def test_materialize_sweep_under_knob(case):
    """An even chunk (30 folds): the knob-on probe equals the knob-off
    probe (the twins compute the same values; the probe reads a computed
    entry) and the JAX sweep's probe under the same set_routing."""
    knobs, dtype, n_l, route = SWEEP_CASES[case]
    flags = (True, True, True, True)
    cfg = T.CVConfig(*flags, dtype=dtype)
    jcfg = J.CVConfig(*flags, dtype=dtype)
    x, y, w = (a.astype(dtype) for a in (X_S, Y_S, W_S))
    js = J.fit(jcfg, x, y, w)
    st = T.fit(cfg, x, y, w, device="cpu")
    idx = np.arange(N).reshape(-1, n_l)
    off = TS.materialize_sweep(cfg, st, idx, batch_size=30)
    T.set_routing(**knobs)
    J.set_routing(**knobs)
    assert TB.route_kernel(cfg, st, n_l, True, True, False,
                           n_folds=30) == route
    assert TS.sweep_chunking(cfg, idx.shape[0], K, K + M, 30)[0] == 30
    got = TS.materialize_sweep(cfg, st, idx, batch_size=30)
    ref = JS.materialize_sweep(jcfg, js, idx, batch_size=30)
    assert float(got) == float(off)
    tol = dict(atol=1e-8, rtol=0) if dtype == np.float64 else dict(rtol=1e-4)
    assert_allclose(float(got), float(ref), **tol)


@pytest.mark.parametrize("knob,dtype", [("df64x2", np.float64),
                                        ("f32x2", np.float32)])
def test_x2_bumps_the_chunk_even(knob, dtype):
    """25-fold chunks become 26 (JAX sweep.py:569-574): 12 chunks over the
    300 folds padded to 312; the probe is then fold 286's, held against
    the per-fold engine."""
    cfg = T.CVConfig(dtype=dtype)
    x, y, w = (a.astype(dtype) for a in (X_S, Y_S, W_S))
    st = T.fit(cfg, x, y, w, device="cpu")
    assert TS.sweep_chunking(cfg, N, K, K + M, 25) == (25, 12)
    T.set_routing(**{knob: True})
    other = "f32x2" if knob == "df64x2" else "df64x2"
    assert TS.sweep_chunking(cfg, N, K, K + M, 25) == (26, 12)
    T.set_routing(**{knob: False, other: True})
    assert TS.sweep_chunking(cfg, N, K, K + M, 25) == (25, 12)
    T.set_routing(**{knob: True, other: False})
    got = TS.materialize_sweep(cfg, st, np.arange(N), batch_size=25)
    (xtx, xty), _ = T.training_matrices(cfg, st, np.array([286]))
    tol = dict(atol=1e-10, rtol=0) if dtype == np.float64 else dict(
        rtol=1e-4)
    assert_allclose(float(got), float(xtx[0, 0] + xty[0, 0]), **tol)
