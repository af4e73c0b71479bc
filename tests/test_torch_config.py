"""The port's CVConfig against the JAX package's, field by field."""

import dataclasses
from itertools import product

import numpy as np
import pytest
import torch

import cvmatrix_tpu as J
import cvmatrix_tpu_torch as T

PROPS = ("resolution", "any_stats", "needs_sum_X", "needs_sum_Y", "needs_WY")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("flags", list(product([False, True], repeat=4)))
def test_config_matches_jax(flags, dtype):
    j = J.CVConfig(*flags, ddof=1, dtype=dtype)
    t = T.CVConfig(*flags, ddof=1, dtype=dtype)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in PROPS:
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.torch_dtype == {np.float32: torch.float32,
                             np.float64: torch.float64}[dtype]
    assert hash(t) == hash(T.CVConfig(*flags, ddof=1, dtype=dtype))


@pytest.mark.parametrize("kw", [dict(dtype=np.int32),
                                dict(matmul_mode="fast")])
def test_config_errors_match_jax(kw):
    with pytest.raises(ValueError) as ej:
        J.CVConfig(**kw)
    with pytest.raises(ValueError) as et:
        T.CVConfig(**kw)
    assert str(et.value) == str(ej.value)
