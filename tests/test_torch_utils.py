"""The port's ``utils/`` and ``native_available`` beside the JAX package's:
the stopwatch's rate, the completion fence's probe, the profiler trace,
the kernel build directory and the shipped-library manifest."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvmatrix_tpu.native as JN
from cvmatrix_tpu.utils import profiling as JP
from cvmatrix_tpu_torch import native as TN
from cvmatrix_tpu_torch.ops import _build
from cvmatrix_tpu_torch.utils import (
    Stopwatch,
    device_fence,
    enable_persistent_cache,
    export_kernels,
    load_kernels,
    trace,
)
from cvmatrix_tpu_torch.utils import aot as TA


@pytest.mark.parametrize("nbytes,elapsed", [(None, 0.5), (10**9, 0.25),
                                            (3 * 10**8, 0.0), (12345, 2e-3)])
def test_stopwatch_gbps_matches_jax(nbytes, elapsed):
    got, ref = Stopwatch(nbytes), JP.Stopwatch(nbytes)
    got.elapsed = ref.elapsed = elapsed
    assert got.gbps == ref.gbps


def test_stopwatch_times_a_block():
    with Stopwatch(8 * 10**6, device="cpu") as sw:
        torch.ones(10**6, dtype=torch.float64).sum()
    assert sw.elapsed > 0
    assert sw.gbps == pytest.approx(8e6 / sw.elapsed / 1e9)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.random((3, 4)), "b": [rng.random(5).astype(np.float32),
                                          np.float64(rng.random())],
            "c": (rng.integers(-9, 9, (2, 2, 2)), None),
            "d": rng.random((1, 1)) * 1e6}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_fence_probe_matches_jax(seed):
    tree = _tree(seed)
    jtree = {k: ([jnp.asarray(x) for x in v] if k == "b" else
                 (jnp.asarray(v[0]), None) if k == "c" else jnp.asarray(v))
             for k, v in tree.items()}
    ttree = {k: ([torch.as_tensor(x) for x in v] if k == "b" else
                 (torch.as_tensor(v[0]), None) if k == "c" else
                 torch.as_tensor(v))
             for k, v in tree.items()}
    assert device_fence(ttree) == JP.device_fence(jtree)


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "prof" / files[0]) as f:
        assert "traceEvents" in json.load(f)
    assert prof.key_averages()


@pytest.fixture
def build_state(monkeypatch):
    """Keep the loader's module state as it was around each test."""
    monkeypatch.setattr(_build, "_BUILD_DIR", None)
    monkeypatch.setattr(_build, "_SHIPPED", {})
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.delenv("CVMATRIX_TPU_TORCH_CACHE", raising=False)


def test_build_dir_default_is_the_checkout_cache(build_state):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert _build.build_dir() == os.path.join(root, ".cache",
                                              "cvmatrix_tpu_torch")


def test_enable_persistent_cache_moves_the_build_dir(build_state, tmp_path):
    default = _build.build_dir()
    d = str(tmp_path / "kernels")
    assert enable_persistent_cache(d) == d
    assert _build.build_dir() == d and os.path.isdir(d)
    assert enable_persistent_cache(d) == d  # idempotent
    assert _build.build_dir() == d
    assert d != default


def test_enable_persistent_cache_reads_the_environment(build_state, tmp_path,
                                                       monkeypatch):
    d = str(tmp_path / "from_env")
    monkeypatch.setenv("CVMATRIX_TPU_TORCH_CACHE", d)
    default = _build.default_build_dir()
    assert _build.build_dir() == default  # no call: nothing moves
    assert enable_persistent_cache() == d == _build.build_dir()


def test_enable_persistent_cache_without_a_setting_keeps_the_default(
        build_state):
    assert enable_persistent_cache() == _build.default_build_dir()


def _manifest(path, version="Build cuda_12.9.r12.9/compiler.0", bad=None,
              drop=None, flags=None):
    os.makedirs(path, exist_ok=True)
    libraries = {}
    for name in _build.library_names():
        if name == drop:
            continue
        key = _build.kernel_key(name, version)
        if name == bad:
            key = "0" * len(key)
        fname = f"{name}_{key}.so"
        (path / fname).write_bytes(b"not a library")
        libraries[name] = {"file": fname, "key": key, "nvcc": version}
    with open(path / TA.MANIFEST, "w") as f:
        json.dump({"nvcc_flags": list(flags or _build.NVCC_FLAGS),
                   "libraries": libraries}, f)


@pytest.mark.parametrize("fault", ["key", "missing", "flags"])
def test_load_kernels_raises_on_a_mismatched_manifest(build_state, tmp_path,
                                                      fault):
    name = _build.library_names()[0]
    _manifest(tmp_path, bad=name if fault == "key" else None,
              drop=name if fault == "missing" else None,
              flags=("-O0",) if fault == "flags" else None)
    with pytest.raises(ValueError):
        load_kernels(str(tmp_path))
    assert _build._SHIPPED == {}


def test_load_kernels_raises_on_a_missing_file(build_state, tmp_path):
    _manifest(tmp_path)
    os.unlink(tmp_path / json.load(open(tmp_path / TA.MANIFEST))[
        "libraries"][_build.library_names()[-1]]["file"])
    with pytest.raises(ValueError, match="missing"):
        load_kernels(str(tmp_path))


def test_load_kernels_makes_the_loader_use_them(build_state, tmp_path,
                                                monkeypatch):
    _manifest(tmp_path)
    _build._LIBS["loocv"] = "an earlier library"
    found = load_kernels(str(tmp_path))
    assert set(found) == set(_build.library_names())
    assert "loocv" not in _build._LIBS  # dropped: the next launch reloads
    opened = []
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda p: opened.append(p)
                        or f"lib:{p}")
    monkeypatch.setattr(_build, "find_nvcc", lambda: pytest.fail("built"))
    assert _build.load_library("loocv") == f"lib:{found['loocv']}"
    assert opened == [found["loocv"]]


def test_export_kernels_needs_nvcc(build_state, tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.os.path, "exists",
                        lambda p: False if p.endswith("nvcc") else
                        os.path.lexists(p))
    with pytest.raises(RuntimeError, match="nvcc"):
        export_kernels(str(tmp_path / "out"))


def test_native_available_matches_jax():
    assert TN.native_available() == JN.native_available()
    assert "native_available" in TN.__all__
