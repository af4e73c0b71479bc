"""Package rules of the port: no JAX, no ``cvmatrix_tpu``, no kernel build at
import time, and no silent CPU route for a CUDA request."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

import cvmatrix_tpu_torch as T
from cvmatrix_tpu_torch.core import batch as TB

ROOT = pathlib.Path(__file__).resolve().parents[1]
IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|cvmatrix_tpu)\b",
                       re.MULTILINE)


def test_import_leaves_jax_out():
    code = (
        "import sys, cvmatrix_tpu_torch, cvmatrix_tpu_torch.models.sweep\n"
        "import cvmatrix_tpu_torch.policy, cvmatrix_tpu_torch.ops.slice_rows\n"
        "from cvmatrix_tpu_torch.models.sweep import cross_validate_reduce\n"
        "from cvmatrix_tpu_torch.ops import _build\n"
        "import cvmatrix_tpu_torch.parallel\n"
        "from cvmatrix_tpu_torch.parallel import distributed, multihost, "
        "dryrun\n"
        "import cvmatrix_tpu_torch.utils, cvmatrix_tpu_torch.native\n"
        "from cvmatrix_tpu_torch.utils import aot, cache, profiling\n"
        "from cvmatrix_tpu_torch.benchmarks import grid, widek_genomics, "
        "mesh_one_chip, mesh_scaling\n"
        "from cvmatrix_tpu_torch.examples import training_matrices, "
        "training_matrices_batched, cross_validation_reduce, "
        "total_cv_fused, kernel_routing_ab, training_matrices_mesh\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'cvmatrix_tpu',\n"
        "                                    'triton', 'pandas',\n"
        "                                    'matplotlib'))\n"
        "print(bad, sorted(_build._LIBS))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[] []"


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "cvmatrix_tpu_torch").rglob("*.py"),
              ROOT / "chip_smoke.py"]
))
def test_sources_never_import_jax(path):
    assert not IMPORT_RE.search((ROOT / path).read_text()), path


def test_parallel_modules_are_checked():
    """The mesh layer's three modules are among the sources the rule above
    reads, and the package exports what the JAX package's does."""
    import cvmatrix_tpu_torch.parallel as TP

    checked = {str(p.relative_to(ROOT / "cvmatrix_tpu_torch"))
               for p in (ROOT / "cvmatrix_tpu_torch").rglob("*.py")}
    assert {"parallel/__init__.py", "parallel/distributed.py",
            "parallel/multihost.py", "parallel/dryrun.py"} <= checked
    assert set(TP.__all__) == {"fit_sharded", "make_mesh",
                               "sharded_cross_validate_reduce",
                               "sharded_training_matrices"}


def test_utils_benchmarks_and_examples_are_checked():
    """The helpers, the benchmark scripts and the examples are among the
    sources the rule above reads, and ``utils`` exports what the port has
    of the JAX package's."""
    import cvmatrix_tpu_torch.utils as TU

    checked = {str(p.relative_to(ROOT / "cvmatrix_tpu_torch"))
               for p in (ROOT / "cvmatrix_tpu_torch").rglob("*.py")}
    assert {f"utils/{m}.py" for m in ("__init__", "aot", "cache",
                                      "profiling")} <= checked
    assert {f"benchmarks/{m}.py" for m in (
        "__init__", "grid", "plot", "widek_genomics", "mesh_one_chip",
        "mesh_scaling")} <= checked
    assert {f"examples/{p.name}" for p in (ROOT / "examples").glob("*.py")
            } <= checked
    assert set(TU.__all__) == {"Stopwatch", "device_fence",
                               "enable_persistent_cache", "export_kernels",
                               "load_kernels", "trace"}


MODULE_LEVEL_PLOTTING = re.compile(r"^(import|from)\s+(pandas|matplotlib)\b",
                                   re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "cvmatrix_tpu_torch").rglob("*.py"),
              ROOT / "chip_smoke.py"]
    if p.name != "plot.py" or p.parent.name != "benchmarks"
))
def test_sources_leave_plotting_out(path):
    """The card's machine has no pandas or matplotlib: only
    ``benchmarks/plot.py`` imports them at module level."""
    assert not MODULE_LEVEL_PLOTTING.search((ROOT / path).read_text()), path


def test_policy_and_reduce_sweeps_are_checked():
    """The routing policy, the reduce sweeps and the slicer are among the
    sources the rule above reads, and the policy is the port's own copy."""
    checked = {p.name for p in (ROOT / "cvmatrix_tpu_torch").rglob("*.py")}
    assert {"policy.py", "sweep.py", "slice_rows.py"} <= checked
    assert T.set_routing.__module__ == "cvmatrix_tpu_torch.policy"
    assert "cross_validate_reduce" in (
        ROOT / "cvmatrix_tpu_torch" / "models" / "sweep.py").read_text()


def test_kernel_source_ships_with_the_package():
    for name in ("loocv.cu", "fold_downdate.cu", "fold_epilogue.cu",
                 "slice_rows.cu"):
        assert (ROOT / "cvmatrix_tpu_torch" / "csrc" / name).is_file()
    assert "cvmatrix_tpu_torch" in (ROOT / "pyproject.toml").read_text()


def test_cuda_request_without_gpu_raises():
    x = np.random.default_rng(0).random((20, 3))
    y = np.random.default_rng(1).random((20, 2))
    cfg = T.CVConfig()
    st = T.fit(cfg, x, y, device="cpu")
    src = TB.prepare_loocv_sources(cfg, st, np.arange(4))
    with pytest.raises(ValueError, match="impl='cuda'"):
        TB.loocv_from_sources(cfg, src, np.arange(4), return_XTY=True,
                              impl="cuda")
