"""The port's per-fold examples (``cvmatrix_tpu_torch.examples``) beside
the JAX package's: each pair runs in subprocesses on the CPU, and their
result lines (shapes, fold keys) agree; a line that prints the difference
between two paths of one engine is held under 1e-10 on the port's side."""

import pytest

from ._examples import numbers, run_pair


def test_training_matrices():
    jax, port = run_pair("training_matrices")
    assert port == jax
    assert len(port) == 6 and port[-1] == "refit OK: (10, 10)"


@pytest.fixture(scope="module")
def batched():
    return run_pair("training_matrices_batched")


def test_training_matrices_batched_shapes_and_keys(batched):
    jax, port = batched
    assert len(port) == len(jax) == 5
    assert port[:3] == jax[:3]


@pytest.mark.parametrize("line", [3, 4])
def test_training_matrices_batched_differences(batched, line):
    jax, port = batched
    assert port[line].split(":")[0] == jax[line].split(":")[0]
    assert numbers(port[line])[-1] < 1e-10  # batched (kernel route) - eager


def test_cross_validation_reduce():
    jax, port = run_pair("cross_validation_reduce")
    assert port[0] == jax[0] == ("per-fold coefficients: (7, 40, 2)  "
                                 "(n_folds, K, M)")
    assert port[1].split(":")[0] == jax[1].split(":")[0]
    # sweep - eager solve, both float64 in the port (JAX solves in float32)
    assert numbers(port[1])[-1] < 1e-10
