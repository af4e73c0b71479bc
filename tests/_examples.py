"""Run one JAX example and its port side by side, for the example tests."""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def run_pair(name, jax_env=None, port_args=("--device", "cpu")):
    """``(jax lines, port lines)``: ``examples/<name>.py`` under the JAX CPU
    backend with 64-bit mode on (the float64 numbers its ``CVConfig`` asks
    for; two of the JAX examples do not switch it on themselves) and
    ``python -m cvmatrix_tpu_torch.examples.<name>``, both at once."""
    base = {**os.environ, "PYTHONPATH": str(ROOT)}
    jax = subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}.py")], cwd=ROOT,
        env={**base, "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "1",
             **(jax_env or {})},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = subprocess.Popen(
        [sys.executable, "-m", f"cvmatrix_tpu_torch.examples.{name}",
         *port_args], cwd=ROOT, env=base,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    outs = []
    try:
        for proc in (jax, port):
            out, err = proc.communicate(timeout=240)
            assert proc.returncode == 0, err[-3000:]
            outs.append(out.strip().splitlines())
    finally:
        for proc in (jax, port):
            proc.kill()
            proc.wait()
    return outs


def numbers(line):
    return [float(x) for x in NUM.findall(line.replace(",", ""))]


def assert_close(a, b, rtol=1e-8):
    """Every number of line ``a`` within ``rtol`` of line ``b``'s."""
    na, nb = numbers(a), numbers(b)
    assert len(na) == len(nb), (a, b)
    for x, y in zip(na, nb):
        assert abs(x - y) <= rtol * max(abs(x), abs(y)), (a, b)
