"""The port's mesh layer (``cvmatrix_tpu_torch.parallel``) on the CPU over gloo.

One worker process a rank, for world sizes 1 to 4, spawned once for the
module: every rank runs every case of ``CASES`` (and the flag grid of
``FLAG_ROUTES``) through ``fit_sharded``, ``sharded_training_matrices`` and
``sharded_cross_validate_reduce`` and writes its results to an ``.npz``,
which the parametrised tests below read. While the workers run, this
process computes the JAX layer's results. The port at world size w is held
against:

- the single-device port (``training_matrices_batched``,
  ``cross_validate_reduce``, ``fit``) at every w;
- the JAX layer's XLA engine (``impl="xla"``, exact float64) on a mesh of w
  of conftest's virtual devices, one w a case (the cases rotate over 1 to
  4; each JAX program compiles, so every case at every w would take
  minutes, and the port at every w is held to the single-device port,
  which is held to the JAX engine): float64 within 1e-8 absolute on
  matrices and reductions, 1e-9 on the fit products (with
  ``assert_allclose``'s default rtol, as ``tests/test_distributed.py``);
  float32 within that file's float32 bounds (rtol 1e-3, atol 1e-1);
- the JAX layer's route for its kernel impl (``impl="pallas"``) on a mesh
  of w devices, for every case and w: which of its four reduce paths it
  takes, read by spies on its path functions, which stop before the
  interpret-mode kernels run (``tests/test_distributed.py`` holds those
  kernels against the XLA engine; here the kernels are the port's twins);
- ``tests/oracle.py`` for the flag grid.

Data: ``tests/data.make_dataset`` at N=601, which no world size from 2 to
4 divides (rows padded with zero weight), and at N=600, which each divides
(an unweighted shard keeps no weights, so its LOOCV count downdate must use
the global row count).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import cvmatrix_tpu_torch as T
from cvmatrix_tpu_torch.core import batch as TB
from cvmatrix_tpu_torch.models import sweep as TS

from .data import make_dataset, zero_fraction
from .oracle import NaiveOracle

WORLDS = (1, 2, 3, 4)
_X1, _Y1, _F1, _W1 = make_dataset(n=601)
_X0, _Y0, _, _W0 = make_dataset(n=600, seed=7)
DATA = {601: (_X1, _Y1, zero_fraction(_W1)), 600: (_X0, _Y0, _W0)}
_rng = np.random.default_rng(3)


def _folds(n_folds, n_l, n=601):
    return np.stack([_rng.permutation(n)[:n_l] for _ in range(n_folds)])


def _mask(n_folds, n_l):
    mk = (_rng.random((n_folds, n_l)) > 0.25).astype(np.float64)
    mk[:, 0] = 1.0
    return mk


_OZ = _folds(2, 520)
_OZ_MASK = np.ones((2, 520))
_OZ_MASK[1, 400:] = 0.0

# name -> the case: kind ("fit" | "tm" | "reduce"), data (N), weighted, the
# config's arguments, folds, mask, entry keywords, and the route expected
# (a reduce path, or the kernel route of the training matrices' fold math)
CASES = {
    "fit_w": dict(kind="fit", data=601, weighted=True),
    "fit_u": dict(kind="fit", data=601, weighted=False),
    "fit_u_even": dict(kind="fit", data=600, weighted=False),
    "tm_loocv": dict(kind="tm", idx=np.arange(13)[:, None], route="loocv"),
    "tm_loocv_u": dict(kind="tm", data=600, weighted=False,
                       idx=np.arange(9)[:, None] * 7, route="loocv"),
    "tm_packed_masked": dict(kind="tm", idx=_folds(11, 4),
                             mask=_mask(11, 4), route="packed"),
    "tm_v3": dict(kind="tm", idx=_folds(7, 10), route="v3"),
    "tm_v3_masked": dict(kind="tm", idx=_folds(7, 10), mask=_mask(7, 10),
                         route="v3"),
    "tm_ozaki": dict(kind="tm", idx=_OZ, mask=_OZ_MASK, route="ozaki_df64"),
    "tm_epilogue": dict(kind="tm", idx=_folds(5, 40), route="epilogue",
                        cfg=dict(matmul_mode="native")),
    "tm_f32_packed": dict(kind="tm", idx=_folds(9, 4), mask=_mask(9, 4),
                          route="packed_f32",
                          cfg=dict(flags=(True, False, True, False), ddof=0,
                                   dtype=np.float32)),
    "tm_f32_large": dict(kind="tm", idx=np.arange(128).reshape(4, 32),
                         route="downdate_f32", cfg=dict(dtype=np.float32)),
    "tm_xtx_only": dict(kind="tm", idx=_folds(6, 5), route="packed",
                        kw=dict(return_XTY=False)),
    "tm_xty_only": dict(kind="tm", idx=_folds(3, 40), route="ozaki_df64",
                        kw=dict(return_XTX=False)),
    "tm_torch": dict(kind="tm", idx=_folds(6, 5), mask=_mask(6, 5),
                     route="torch", kw=dict(impl="torch")),
    # negative fold rows (wrapped as NumPy does) and the folds and mask
    # handed over as tensors
    "tm_negative_tensors": dict(kind="tm", idx=_folds(6, 4) - 601,
                                mask=_mask(6, 4), route="packed",
                                tensors=True),
    "tm_untrimmed": dict(kind="tm", idx=np.arange(13)[:, None] * 3,
                         route="loocv", kw=dict(trim_padding=False)),
    "red_identity_w": dict(kind="reduce", idx=np.arange(601)[:, None],
                           route="identity", kw=dict(batch_size=64)),
    "red_identity_u": dict(kind="reduce", data=600, weighted=False,
                           idx=np.arange(600)[:, None], route="identity",
                           kw=dict(batch_size=64)),
    # LOOCV out of natural order, or a short prefix, leaves the identity
    # path for the small-fold one
    "red_loocv_perm": dict(kind="reduce", idx=_rng.permutation(601)[:, None],
                           route="smallfold", kw=dict(batch_size=128)),
    "red_loocv_prefix": dict(kind="reduce", idx=np.arange(16)[:, None],
                             route="smallfold", kw=dict(batch_size=8)),
    "red_small_w": dict(kind="reduce", idx=_folds(19, 5), route="smallfold",
                        kw=dict(batch_size=8)),
    "red_small_u": dict(kind="reduce", weighted=False, idx=_folds(19, 5),
                        route="smallfold", kw=dict(batch_size=8)),
    "red_small_f32_masked": dict(
        kind="reduce", weighted=False, idx=_folds(13, 4), mask=_mask(13, 4),
        route="smallfold", kw=dict(batch_size=8),
        cfg=dict(flags=(True, False, True, False), ddof=0,
                 dtype=np.float32)),
    "red_v3": dict(kind="reduce", idx=_folds(11, 10), route="v3",
                   kw=dict(batch_size=8)),
    "red_v3_masked": dict(kind="reduce", idx=_folds(11, 10),
                          mask=_mask(11, 10), route="v3",
                          kw=dict(batch_size=8)),
    "red_large_f32": dict(kind="reduce", idx=np.arange(128).reshape(4, 32),
                          route="generic", kw=dict(batch_size=4),
                          cfg=dict(dtype=np.float32)),
    "red_large_f64": dict(kind="reduce", idx=_OZ, mask=_OZ_MASK,
                          route="generic"),
    "red_epilogue": dict(kind="reduce", idx=_folds(5, 40), route="generic",
                         kw=dict(batch_size=4),
                         cfg=dict(matmul_mode="native")),
    "red_hoist_off": dict(kind="reduce", idx=_folds(8, 5), route="generic",
                          kw=dict(batch_size=8),
                          policy=dict(hoist_reduce=False)),
    "red_torch": dict(kind="reduce", idx=_folds(19, 5), route="generic",
                      kw=dict(batch_size=8, impl="torch")),
    "red_xty_only": dict(kind="reduce", idx=_folds(9, 5), route="smallfold",
                         kw=dict(batch_size=4, return_XTX=False)),
}
for _name, _case in CASES.items():
    _case.setdefault("data", 601)
    _case.setdefault("weighted", True)
    _case.setdefault("mask", None)
    _case.setdefault("kw", {})
    _case.setdefault("policy", {})
# the world size at which a case is held against the JAX layer's numbers
JAX_WORLD = {name: WORLDS[i % len(WORLDS)] for i, name in enumerate(CASES)}

# The flag grid: 16 flag sets x weighted or not, through three fold-math
# routes of sharded_training_matrices, against the single-device port and
# the oracle.
FLAG_ROUTES = {"loocv": (np.arange(11)[:, None] * 5, None),
               "packed": (_folds(7, 3), _mask(7, 3)),
               "v3": (_folds(5, 10), _mask(5, 10))}
FLAGS = list(itertools.product([True, False], repeat=4))


def _flag_name(flags, weighted, route):
    return ("flags_" + "".join("T" if f else "F" for f in flags)
            + ("_w_" if weighted else "_u_") + route)


def _inputs(case):
    """``(X, Y, weights)`` of a case (``Y`` always, ``weights`` or None)."""
    X, Y, w = DATA[case["data"]]
    return X, Y, (w if case["weighted"] else None)


def _config(module, case):
    c = dict(case.get("cfg", {}))
    flags = c.pop("flags", (True, True, True, True))
    return module.CVConfig(*flags, c.pop("ddof", 1), **c)


def _reduce_t(mats, stats):
    parts = ([mats[0].diagonal(), mats[1][:, 0]] if isinstance(mats, tuple)
             else [mats[:, 0]])
    if stats[0] is not None:
        parts.append(stats[0][0])
    return torch.cat(parts)


def _reduce_j(mats, stats):
    import jax.numpy as jnp

    parts = ([jnp.diagonal(mats[0]), mats[1][:, 0]]
             if isinstance(mats, tuple) else [mats[:, 0]])
    if stats[0] is not None:
        parts.append(stats[0][0])
    return jnp.concatenate(parts)


def _flat_tm(out):
    """``((mats), stats)`` of the training matrices -> {key: array}."""
    mats, stats = out
    mats = mats if isinstance(mats, tuple) else (mats,)
    res = {f"m{i}": np.asarray(m) for i, m in enumerate(mats)}
    res.update({f"s{i}": np.asarray(s) for i, s in enumerate(stats)
                if s is not None})
    return res


# --------------------------------------------------------------------------- #
# Worker: one rank                                                            #
# --------------------------------------------------------------------------- #


def _worker(rank: int, world: int, port: int, out_dir: str) -> None:
    """Run every case on this rank and write ``w{world}_r{rank}.npz``."""
    from cvmatrix_tpu_torch.parallel import distributed as D
    from cvmatrix_tpu_torch.parallel import multihost as MH
    from cvmatrix_tpu_torch.parallel.dryrun import dryrun_rank

    torch.set_num_threads(1)
    MH.initialize(None if world == 1 else f"tcp://127.0.0.1:{port}", world,
                  rank, device_type="cpu")
    MH.initialize()  # a no-op once a group exists
    mesh = D.make_mesh("cpu")
    out = {}
    taken = []

    def spy(name, label):
        fn = getattr(D, name)

        def wrapped(*a, **kw):
            taken.append(label(a))
            return fn(*a, **kw)
        setattr(D, name, wrapped)

    spy("_sharded_loocv_identity_reduce", lambda a: "identity")
    # the route the hoisted body's fold plan takes, by the JAX layer's name
    # for its body: "v3", or "smallfold" for the packed routes
    spy("_sharded_hoisted_reduce",
        lambda a: "v3" if a[7].startswith("v3") else "smallfold")
    kernel_routes = []
    route_kernel = TB.route_kernel

    def route_spy(*a, **kw):
        kernel_routes.append(route_kernel(*a, **kw))
        return kernel_routes[-1]
    TB.route_kernel = route_spy

    states = {}
    for name, case in CASES.items():
        cfg = _config(T, case)
        X, Y, w = _inputs(case)
        key = (case["data"], case["weighted"], cfg)
        if key not in states:
            states[key] = D.fit_sharded(cfg, mesh, X, Y, w)
        st = states[key]
        if case["kind"] == "fit":
            loc = st.local
            for f in ("XTX", "XTY", "sum_X", "sum_sq_X", "sum_Y", "sum_w",
                      "num_nonzero_w"):
                out[f"{name}/{f}"] = getattr(loc, f).numpy()
            out[f"{name}/n_rows"] = np.array([st.n_rows, loc.N])
            continue
        before = T.policy()
        T.set_routing(**case["policy"])
        try:
            del taken[:], kernel_routes[:]
            if case["kind"] == "tm":
                idx, mask = case["idx"], case["mask"]
                if case.get("tensors"):
                    idx, mask = torch.from_numpy(idx), torch.from_numpy(mask)
                res = D.sharded_training_matrices(cfg, st, idx, mask,
                                                  mesh=mesh, **case["kw"])
                if not case["kw"].get("trim_padding", True):
                    res, n = res
                    out[f"{name}/n_folds"] = np.array([n])
                for k, v in _flat_tm(res).items():
                    out[f"{name}/{k}"] = v
                route = kernel_routes[0] if kernel_routes else "torch"
            else:
                res = D.sharded_cross_validate_reduce(
                    cfg, st, case["idx"], case["mask"], mesh=mesh,
                    reduce_fn=_reduce_t, **case["kw"])
                out[f"{name}/red"] = res.numpy()
                route = taken[0] if taken else "generic"
            out[f"{name}/route"] = np.array(route)
        finally:
            T.set_routing(**dataclasses.asdict(before))

    for flags, weighted in itertools.product(FLAGS, (True, False)):
        cfg = T.CVConfig(*flags, 1)
        X, Y, w = DATA[601]
        st = D.fit_sharded(cfg, mesh, X, Y, w if weighted else None)
        for route, (idx, mask) in FLAG_ROUTES.items():
            del kernel_routes[:]
            res = D.sharded_training_matrices(cfg, st, idx, mask, mesh=mesh)
            name = _flag_name(flags, weighted, route)
            for k, v in _flat_tm(res).items():
                out[f"{name}/{k}"] = v
            out[f"{name}/route"] = np.array(kernel_routes[0])

    # negative weights: the one bad row lives on rank 0 only, yet every rank
    # raises (and none waits in a collective)
    X, Y, w = DATA[601]
    bad = w.copy()
    bad[0] = -1.0
    try:
        D.fit_sharded(T.CVConfig(), mesh, X, Y, bad)
        out["neg/raised"] = np.array(0)
    except ValueError:
        out["neg/raised"] = np.array(1)
    st = states[(601, True, T.CVConfig())]
    try:
        D.sharded_training_matrices(T.CVConfig(), st, np.arange(4)[:, None],
                                    mesh=mesh, impl="cuda")
        out["cuda/raised"] = np.array(0)
    except ValueError:
        out["cuda/raised"] = np.array(1)
    # multihost: this rank's rows alone give the state fit_sharded gives
    start, stop = MH.host_row_slice(601, mesh)
    out["mh/slice"] = np.array([start, stop])
    mh = MH.fit_sharded_multihost(T.CVConfig(), mesh, X[start:stop],
                                  Y[start:stop], w[start:stop],
                                  n_rows_global=601)
    out["mh/XTX"] = mh.local.XTX.numpy()
    out["mh/X"] = mh.local.X.numpy()
    out["fs/XTX"] = st.local.XTX.numpy()
    out["fs/X"] = st.local.X.numpy()
    dryrun_rank(mesh)
    out["dryrun/ok"] = np.array(1)
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(out_dir, f"w{world}_r{rank}.npz"), **out)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# --------------------------------------------------------------------------- #
# The JAX side                                                                #
# --------------------------------------------------------------------------- #


class _Taken(Exception):
    pass


def _jax_side():
    """``(routes, numbers)``: the JAX layer's reduce path of every reduce
    case at every world size (kernel impl), and its XLA results of every
    case at the case's ``JAX_WORLD``."""
    import jax

    import cvmatrix_tpu as J
    from cvmatrix_tpu.parallel import distributed as JD

    routes, numbers = {}, {}

    def taken(label):
        def spy(*a, **kw):
            raise _Taken(label(a))
        return spy

    states = {}

    def state(case, w, cfg):
        key = (case["data"], case["weighted"], cfg, w)
        if key not in states:
            X, Y, wts = _inputs(case)
            states[key] = JD.fit_sharded(cfg, JD.make_mesh(
                jax.devices()[:w]), X, Y, wts)
        return states[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JD, "_sharded_loocv_identity_reduce",
                   taken(lambda a: "identity"))
        mp.setattr(JD, "_sharded_hoisted_reduce", taken(
            lambda a: "smallfold" if a[8] is JD._smallfold_program else "v3"))
        mp.setattr(JD, "_reduce_program", taken(lambda a: "generic"))
        base = J.policy()
        for name, case in CASES.items():
            if case["kind"] != "reduce":
                continue
            kw = dict(case["kw"])
            impl = "xla" if kw.pop("impl", "auto") == "torch" else "pallas"
            J.set_routing(**case["policy"])
            try:
                for w in WORLDS:
                    # the gates read the padded row count and the shapes,
                    # the same for every configuration of the case's data
                    st = state(dict(case, cfg={}), w, J.CVConfig())
                    try:
                        JD.sharded_cross_validate_reduce(
                            _config(J, case), st, case["idx"], case["mask"],
                            mesh=JD.make_mesh(jax.devices()[:w]),
                            reduce_fn=_reduce_j, impl=impl, interpret=True,
                            **kw)
                    except _Taken as t:
                        routes[name, w] = str(t)
            finally:
                J.set_routing(**dataclasses.asdict(base))

    for name, case in CASES.items():
        w = JAX_WORLD[name]
        cfg = _config(J, case)
        st = state(case, w, cfg)
        mesh = JD.make_mesh(jax.devices()[:w])
        kw = {k: v for k, v in case["kw"].items()
              if k not in ("impl", "trim_padding")}
        if case["kind"] == "fit":
            numbers[name] = {f: np.asarray(getattr(st, f)) for f in (
                "XTX", "XTY", "sum_X", "sum_sq_X", "sum_Y", "sum_w")}
        elif case["kind"] == "tm":
            # the JAX layer takes rows in [0, N)
            idx = case["idx"] % case["data"]
            numbers[name] = _flat_tm(JD.sharded_training_matrices(
                cfg, st, idx, case["mask"], mesh=mesh, impl="xla", **kw))
        else:
            numbers[name] = {"red": np.asarray(
                JD.sharded_cross_validate_reduce(
                    cfg, st, case["idx"], case["mask"], mesh=mesh,
                    reduce_fn=_reduce_j, impl="xla", **kw))}
    return routes, numbers


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(port, jax_routes, jax_numbers)``: ``port[w][rank]`` the arrays a
    rank of world size w wrote."""
    out = tmp_path_factory.mktemp("mesh")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_", "RANK", "WORLD_SIZE",
                                "LOCAL_RANK", "MASTER_"))}
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for w in WORLDS:
        port = _free_port()
        for r in range(w):
            code = (f"from tests.test_torch_parallel import _worker; "
                    f"_worker({r}, {w}, {port}, {str(out)!r})")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], cwd=repo, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        jax_routes, jax_numbers = _jax_side()
    finally:
        logs = []
        for p in procs:
            try:
                logs.append((p.communicate(timeout=240)[0], p.returncode))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
    for log, rc in logs:
        assert rc == 0, log[-4000:]
    port = {w: [dict(np.load(out / f"w{w}_r{r}.npz")) for r in range(w)]
            for w in WORLDS}
    return port, jax_routes, jax_numbers


# --------------------------------------------------------------------------- #
# The single-device port                                                      #
# --------------------------------------------------------------------------- #

_single_states = {}


def _single(case, cfg):
    key = (case["data"], case["weighted"], cfg)
    if key not in _single_states:
        X, Y, w = _inputs(case)
        _single_states[key] = T.fit(cfg, X, Y, w, device="cpu")
    return _single_states[key]


def _single_result(name):
    case = CASES[name]
    cfg = _config(T, case)
    st = _single(case, cfg)
    kw = dict(case["kw"])
    before = T.policy()
    T.set_routing(**case["policy"])
    try:
        if case["kind"] == "tm":
            kw.pop("trim_padding", None)
            return _flat_tm(TB.training_matrices_batched(
                cfg, st, case["idx"], case["mask"], **kw))
        kw.pop("batch_size", None)
        return {"red": TS.cross_validate_reduce(
            cfg, st, case["idx"], case["mask"], reduce_fn=_reduce_t,
            **kw).numpy()}
    finally:
        T.set_routing(**dataclasses.asdict(before))


def _tol(name):
    """(rtol, atol): 1e-8 absolute in float64 (with ``assert_allclose``'s
    default rtol, as ``tests/test_distributed.py`` holds the JAX layer),
    the JAX layer's float32 bounds in float32."""
    f32 = CASES[name].get("cfg", {}).get("dtype") == np.float32
    return (1e-3, 1e-1) if f32 else (1e-7, 1e-8)


def _close(got, want, rtol, atol, what):
    assert set(got) >= set(want), (what, sorted(got), sorted(want))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


def _case_arrays(arrays, name):
    pre = name + "/"
    return {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}


# --------------------------------------------------------------------------- #
# Tests                                                                       #
# --------------------------------------------------------------------------- #

FIT = [n for n, c in CASES.items() if c["kind"] == "fit"]
TM = [n for n, c in CASES.items() if c["kind"] == "tm"]
RED = [n for n, c in CASES.items() if c["kind"] == "reduce"]


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("name", FIT)
def test_fit_sharded_matches_single_device(runs, name, w):
    """Summed products and statistics on every rank; the padded row count."""
    port = runs[0][w]
    case = CASES[name]
    ref = _single(case, T.CVConfig())
    for arrays in port:
        got = _case_arrays(arrays, name)
        for f in ("XTX", "XTY"):
            np.testing.assert_allclose(got[f], getattr(ref, f).numpy(),
                                       atol=1e-9, err_msg=f)
        for f in ("sum_X", "sum_sq_X", "sum_Y", "sum_w"):
            np.testing.assert_allclose(got[f], getattr(ref, f).numpy(),
                                       atol=1e-10, err_msg=f)
        assert int(got["num_nonzero_w"]) == int(ref.num_nonzero_w)
        n = case["data"]
        assert tuple(got["n_rows"]) == (-(-n // w) * w, -(-n // w))


@pytest.mark.parametrize("name", FIT)
def test_fit_sharded_matches_jax(runs, name):
    port, _, jax_numbers = runs
    got = _case_arrays(port[JAX_WORLD[name]][0], name)
    for f, v in jax_numbers[name].items():
        np.testing.assert_allclose(got[f], v, atol=1e-9, err_msg=f)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("name", TM)
def test_training_matrices_match_single_device(runs, name, w):
    """Every fold's matrices and statistics on every rank (trimmed), or this
    rank's slice of the padded folds (untrimmed); the fold math's route."""
    case = CASES[name]
    ref = _single_result(name)
    n_folds = case["idx"].shape[0]
    f_loc = -(-n_folds // w)
    padded = {k: np.concatenate([v, np.repeat(v[-1:], f_loc * w - n_folds, 0)])
              for k, v in ref.items()}
    for rank, arrays in enumerate(runs[0][w]):
        got = _case_arrays(arrays, name)
        assert str(got.pop("route")) == case["route"]
        if case["kw"].get("trim_padding", True):
            _close(got, ref, *_tol(name), f"{name} rank {rank}")
        else:
            assert got.pop("n_folds").tolist() == [n_folds]
            want = {k: v[rank * f_loc:(rank + 1) * f_loc]
                    for k, v in padded.items()}
            _close(got, want, *_tol(name), f"{name} rank {rank}")


@pytest.mark.parametrize("name", [n for n in TM if n != "tm_untrimmed"])
def test_training_matrices_match_jax(runs, name):
    port, _, jax_numbers = runs
    got = _case_arrays(port[JAX_WORLD[name]][0], name)
    got.pop("route")
    _close(got, jax_numbers[name], *_tol(name), name)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("name", RED)
def test_reduce_route_matches_jax(runs, name, w):
    """The port takes the JAX layer's reduce path at every world size."""
    port, jax_routes, _ = runs
    for arrays in port[w]:
        route = str(arrays[f"{name}/route"])
        assert route == jax_routes[name, w] == CASES[name]["route"], (
            route, jax_routes[name, w])


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("name", RED)
def test_reduce_matches_single_device(runs, name, w):
    ref = _single_result(name)
    for rank, arrays in enumerate(runs[0][w]):
        got = {"red": arrays[f"{name}/red"]}
        _close(got, ref, *_tol(name), f"{name} rank {rank}")


@pytest.mark.parametrize("name", RED)
def test_reduce_matches_jax(runs, name):
    port, _, jax_numbers = runs
    got = {"red": port[JAX_WORLD[name]][0][f"{name}/red"]}
    _close(got, jax_numbers[name], *_tol(name), name)


@pytest.mark.parametrize("route", list(FLAG_ROUTES))
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("flags", FLAGS,
                         ids=["".join("T" if f else "F" for f in fl)
                              for fl in FLAGS])
def test_flag_grid(runs, flags, weighted, route):
    """16 flag sets x weights through three fold-math routes at every world
    size: the single-device port within 1e-8, the route, and the first
    fold against the oracle."""
    cfg = T.CVConfig(*flags, 1)
    X, Y, w = DATA[601]
    idx, mask = FLAG_ROUTES[route]
    st = T.fit(cfg, X, Y, w if weighted else None, device="cpu")
    ref = _flat_tm(TB.training_matrices_batched(cfg, st, idx, mask))
    name = _flag_name(flags, weighted, route)
    for world in WORLDS:
        got = _case_arrays(runs[0][world][-1], name)
        assert str(got.pop("route")) == route
        _close(got, ref, 1e-7, 1e-8, f"{name} w={world}")
    oracle = NaiveOracle(*flags, ddof=1).fit(X, Y, w if weighted else None)
    val = idx[0] if mask is None else idx[0][mask[0] > 0]
    (xtx, xty), _ = oracle.training_XTX_XTY(np.setdiff1d(np.arange(601), val))
    np.testing.assert_allclose(got["m0"][0], xtx, atol=1e-8)
    np.testing.assert_allclose(got["m1"][0], xty, atol=1e-8)


@pytest.mark.parametrize("w", WORLDS)
def test_negative_weights_raise_on_every_rank(runs, w):
    assert [int(a["neg/raised"]) for a in runs[0][w]] == [1] * w


@pytest.mark.parametrize("w", WORLDS)
def test_cuda_impl_on_cpu_mesh_raises(runs, w):
    assert [int(a["cuda/raised"]) for a in runs[0][w]] == [1] * w


@pytest.mark.parametrize("w", WORLDS)
def test_multihost_rows_and_fit(runs, w):
    """One contiguous row range a rank; the fit from each rank's rows alone
    is fit_sharded's, bit for bit (one code path)."""
    per = -(-601 // w)
    for rank, a in enumerate(runs[0][w]):
        assert tuple(a["mh/slice"]) == (min(rank * per, 601),
                                        min((rank + 1) * per, 601))
        np.testing.assert_array_equal(a["mh/XTX"], a["fs/XTX"])
        np.testing.assert_array_equal(a["mh/X"], a["fs/X"])


@pytest.mark.parametrize("w", WORLDS)
def test_dryrun_rank(runs, w):
    assert [int(a["dryrun/ok"]) for a in runs[0][w]] == [1] * w


def test_initialize_without_a_group_raises(monkeypatch):
    from cvmatrix_tpu_torch.parallel import multihost

    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="no process group"):
        multihost.initialize(device_type="cpu")
    assert not torch.distributed.is_initialized()


def test_cuda_mesh_without_a_card_raises():
    from cvmatrix_tpu_torch.parallel import make_mesh

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA mesh does not raise")
    with pytest.raises(ValueError, match="no CUDA card"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no default process group"):
        make_mesh("cpu")


def test_dryrun_multichip_spawns_ranks():
    """The spawned dry run over two gloo ranks on the CPU."""
    from cvmatrix_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(2, device_type="cpu")
