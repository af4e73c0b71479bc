"""The port's kernel router against the JAX package's gates.

``route_kernel`` must send every fold batch where the JAX package sends it:
``large_fold_threshold``, ``ozaki_v3_ok``, and the ``use_fused`` test of
the large-fold path over ``_padded_dims`` (with ``matmul_mode="auto"``
exact, as on the TPU the gates were written for). The lattice covers the
thresholds of 10 and 32 rows, the v3 bound ``Sp * Lp * 65^2 < 2^24`` (L =
400 passes and L = 500 fails at K = 500), the 1024-row fusion limit, and
geometries with square tiles, non-square tiles and no Y. Float32 batches
are held against the JAX f32 engine's gates on their own lattice.
"""

from itertools import product

import numpy as np
import pytest

import cvmatrix_tpu as J
import cvmatrix_tpu_torch as T
from cvmatrix_tpu.core import batch as JB
from cvmatrix_tpu.ops import kernels as JK
from cvmatrix_tpu_torch.core import batch as TB

LS = [1, 2, 9, 10, 31, 32, 100, 400, 500, 1024, 1025]
SHAPES = [(500, 10), (500, None), (100, 100), (6, 2)]
MODES = ["auto", "exact", "native"]


def jax_route(cfg, js, n_l, xtx, xty, masked):
    """The JAX package's choice (models/sweep.py:614-745, with the large-
    fold path's use_fused test at core/batch.py:1097-1100)."""
    if n_l == 1 and not masked and JB.loocv_single_tile_ok(cfg, js, xtx,
                                                           xty):
        return "loocv"
    threshold = JB.large_fold_threshold(cfg, js, xtx, xty)
    if n_l >= threshold and JB.ozaki_v3_ok(cfg, js, xtx, xty, n_l):
        return "v3"
    if n_l < threshold:
        return "packed"
    _, _, kp, cp, _ = JB._padded_dims(js, xtx, xty)
    # _use_exact: "auto" is exact for f64 on the TPU
    exact = cfg.matmul_mode in ("auto", "exact")
    return ("ozaki_df64" if kp == cp and kp <= 512 and n_l <= 1024 and exact
            else "epilogue")


def old_rule(k, m, n_l, xty):
    """The router the port had before (``unported_kernel``), kept here to
    show where it left the JAX gates."""
    c = k + ((m or 0) if xty else 0)
    if n_l < 10:
        return "packed"
    if n_l <= 1024 and c <= 512:
        return "v3"
    return "epilogue"


def both_states(k, m, mode):
    x = np.zeros((3, k))
    y = None if m is None else np.zeros((3, m))
    flags = (False, False, False, False)
    js = J.fit(J.CVConfig(*flags), x, y)
    st = T.FitState.from_numpy({
        f: None if getattr(js, f) is None else np.asarray(getattr(js, f))
        for f in js.__dataclass_fields__
    })
    return (J.CVConfig(*flags, matmul_mode=mode), js,
            T.CVConfig(*flags, matmul_mode=mode), st)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k,m", SHAPES)
def test_route_kernel_matches_jax_gates(k, m, mode):
    jcfg, js, cfg, st = both_states(k, m, mode)
    flag_sets = [(True, True), (True, False), (False, True)]
    if m is None:
        flag_sets = [(True, False)]
    for (xtx, xty), n_l, masked in product(flag_sets, LS, [False, True]):
        assert TB.route_kernel(cfg, st, n_l, xtx, xty, masked) == jax_route(
            jcfg, js, n_l, xtx, xty, masked), (k, m, mode, xtx, xty, n_l,
                                                masked)
    for xtx, xty in flag_sets:
        assert (TB.large_fold_threshold(cfg, st, xtx, xty)
                == JB.large_fold_threshold(jcfg, js, xtx, xty))
        for n_l in LS:
            assert (TB.ozaki_v3_ok(cfg, st, xtx, xty, n_l)
                    == JB.ozaki_v3_ok(jcfg, js, xtx, xty, n_l))


def test_reference_grid_routes():
    """The reference grid (N=100,000, K=500, M=10): the route per P."""
    _, _, cfg, st = both_states(500, 10, "auto")
    expect = {100_000: "loocv", 25_000: "packed", 10_000: "v3", 1_000: "v3",
              100: "ozaki_df64", 10: "epilogue", 3: "epilogue"}
    for p, route in expect.items():
        n_l = -(-100_000 // p)
        assert TB.route_kernel(cfg, st, n_l, True, True, p == 3) == route


def test_old_router_left_the_jax_gates():
    """Where the previous rule named another kernel than JAX runs: folds of
    500-1024 rows at K=500, and a non-square tile (K=100, M=100) at 10-31
    rows and from 32 rows; route_kernel agrees with JAX at each."""
    for (k, m), n_l, jax_says in (((500, 10), 500, "ozaki_df64"),
                                  ((500, 10), 1024, "ozaki_df64"),
                                  ((100, 100), 10, "packed"),
                                  ((100, 100), 31, "packed"),
                                  ((100, 100), 32, "epilogue"),
                                  ((100, 100), 400, "epilogue")):
        jcfg, js, cfg, st = both_states(k, m, "auto")
        assert jax_route(jcfg, js, n_l, True, True, False) == jax_says
        assert old_rule(k, m, n_l, True) == "v3"
        assert TB.route_kernel(cfg, st, n_l, True, True, False) == jax_says


def test_trim_groups_match_jax():
    for n_l in (1, 10, 32, 33, 100, 128, 384, 400, 480, 500, 1024, 5000):
        assert TB.ozaki_trim_groups(n_l) == JK.ozaki_trim_groups(n_l)


# float32 lattice: one-row folds unmasked and masked, then fold sizes
# around LARGE_FOLD_ROWS; K+M = 1030 > 1024 takes one-row folds off LOOCV
F32_LS = [(1, False), (1, True), (2, False), (31, False), (32, False),
          (100, False), (1025, False)]
F32_SHAPES = [(500, 10), (500, None), (100, 100), (6, 2), (1020, 10)]


def jax_route_f32(cfg, js, n_l, xtx, xty, masked):
    """The JAX f32 engine's choice: the sweep's LOOCV condition
    (models/sweep.py:614-616), then ``LARGE_FOLD_ROWS`` as
    ``training_matrices_batched`` applies it (core/batch.py:752-767),
    which for f32 is also the sweep's ``large_fold_threshold``."""
    if n_l == 1 and not masked and JB.loocv_single_tile_ok(cfg, js, xtx,
                                                           xty):
        return "loocv"
    assert JB.large_fold_threshold(cfg, js, xtx, xty) == JB.LARGE_FOLD_ROWS
    return "downdate_f32" if n_l >= JB.LARGE_FOLD_ROWS else "packed_f32"


@pytest.mark.parametrize("k,m", F32_SHAPES)
def test_float32_route_kernel_matches_jax_gates(k, m):
    x = np.zeros((3, k), np.float32)
    y = None if m is None else np.zeros((3, m), np.float32)
    flags = (False, False, False, False)
    jcfg = J.CVConfig(*flags, dtype=np.float32)
    js = J.fit(jcfg, x, y)
    cfg = T.CVConfig(*flags, dtype=np.float32)
    st = T.FitState.from_numpy({
        f: None if getattr(js, f) is None else np.asarray(getattr(js, f))
        for f in js.__dataclass_fields__
    })
    assert st.X.dtype == T.CVConfig(dtype=np.float32).torch_dtype
    sides = [(True, True), (True, False), (False, True)]
    if m is None:
        sides = [(True, False)]
    for (xtx, xty), (n_l, masked) in product(sides, F32_LS):
        got = TB.route_kernel(cfg, st, n_l, xtx, xty, masked)
        assert got == jax_route_f32(jcfg, js, n_l, xtx, xty, masked), (
            k, m, xtx, xty, n_l, masked)
        assert got in ("loocv", "packed_f32", "downdate_f32")
    if (k, m) == (1020, 10):  # [X | Y] past one 1024 tile
        assert TB.route_kernel(cfg, st, 1, True, True, False) == "packed_f32"
        assert TB.route_kernel(cfg, st, 1, True, False, False) == "loocv"


def test_float32_routes_raise_naming_kernel():
    """Float32 batches no longer raise: each route names the JAX f32
    engine's kernel it ports."""
    _, _, _, st = both_states(6, 2, "auto")
    cfg32 = T.CVConfig(dtype=np.float32)
    for n_l, masked, route, kernel in (
            (1, False, "loocv", "fused_loocv_f32 "),
            (1, True, "packed_f32", "fused_downdate_f32_packed "),
            (31, False, "packed_f32", "fused_downdate_f32_packed "),
            (32, False, "downdate_f32", "fused_downdate ("),
            (1025, True, "downdate_f32", "fused_downdate (")):
        assert TB.route_kernel(cfg32, st, n_l, True, True, masked) == route
        assert kernel in TB.TPU_KERNELS[route]
