"""The mantissa slicer of the port: the plain twin of the port of
``slice_rows`` against the JAX package.

The inputs are those of ``tests/test_precise.py``'s slicer test, built with
the JAX package's helpers (``df_from_f64``, ``_column_scale``) and handed
to both packages as NumPy arrays. The slices are integers, so the twin is
held bit for bit to the JAX Pallas kernel in interpret mode and to its
eager math ``_slice_rows_math``, in both layouts. The CUDA kernel is held
bit for bit to the twin on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvmatrix_tpu.ops import kernels as JK
from cvmatrix_tpu.ops.df64 import df_from_f64
from cvmatrix_tpu.ops.precise import _column_scale, _pow2
from cvmatrix_tpu_torch.ops import slice_rows as TS


def _inputs():
    """``(xh, xl, pows, e)`` as NumPy: test_precise.py's slicer inputs."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(256, 128)) * 10.0 ** rng.integers(-6, 6, (1, 128))
    e = _column_scale(jnp.asarray(x))
    h1 = jnp.clip(-e, -127, 127)
    pows = jnp.stack([jnp.ldexp(jnp.float32(1.0), h1),
                      jnp.ldexp(jnp.float32(1.0), -e - h1)])
    xh, xl = df_from_f64(jnp.asarray(x))
    return tuple(np.array(a) for a in (xh, xl, pows, e))


XH, XL, POWS, E = _inputs()


def port(xh, xl, pows, **kw):
    return TS.slice_rows(torch.from_numpy(xh), torch.from_numpy(xl),
                         torch.from_numpy(pows), **kw).numpy()


@pytest.mark.parametrize("n_slices", [1, 4, 10])
@pytest.mark.parametrize("row_major", [True, False])
def test_twin_bit_equal_to_jax_kernel(row_major, n_slices):
    got = port(XH, XL, POWS, n_slices=n_slices, row_major=row_major)
    ref = np.asarray(JK.slice_rows(jnp.asarray(XH), jnp.asarray(XL),
                                   jnp.asarray(POWS), n_slices=n_slices,
                                   row_major=row_major, interpret=True))
    assert got.dtype == np.int8 and got.shape == ref.shape
    assert np.array_equal(got, ref)
    math = JK._slice_rows_math(jnp.asarray(XH), jnp.asarray(XL),
                               jnp.asarray(POWS[0:1]), jnp.asarray(POWS[1:2]),
                               n_slices)
    math = np.stack([np.asarray(s) for s in math],
                    axis=1 if row_major else 0)
    assert np.array_equal(got, math)


@pytest.mark.parametrize("row_major", [True, False])
def test_exact_decomposition_and_range(row_major):
    """Slices within [-65, 65] whose weighted sum is the scaled pair to
    2^-58 (test_precise.py's contract)."""
    sl = port(XH, XL, POWS, row_major=row_major)
    stack = (np.moveaxis(sl, 1, 0) if row_major else sl).astype(np.float64)
    assert stack.shape == (10, 256, 128)
    assert np.abs(stack).max() <= 65
    recon = sum(stack[s] * 2.0 ** (-6 * (s + 1)) for s in range(10))
    pair = XH.astype(np.float64) + XL.astype(np.float64)
    scaled = pair * np.asarray(_pow2(jnp.asarray(-E)))[None, :]
    assert np.max(np.abs(recon - scaled)) < 2.0 ** -58


def test_ties_round_to_even():
    """3.5 after the first scaling: ties to even give q0 = 4 and adj =
    round(-0.5) = 0, so the slices are 4 then -32; rounding ties away from
    zero would give 3 then 32. The twin matches the JAX kernel."""
    xh = np.zeros((8, 4), np.float32)
    xh[:, 0] = 3.5 / 64
    xh[:, 1] = -2.5 / 64
    xl = np.zeros_like(xh)
    pows = np.ones((2, 4), np.float32)
    got = port(xh, xl, pows, n_slices=3, block_rows=8)
    ref = np.asarray(JK.slice_rows(jnp.asarray(xh), jnp.asarray(xl),
                                   jnp.asarray(pows), n_slices=3,
                                   block_rows=8, interpret=True))
    assert np.array_equal(got, ref)
    assert got[0, :, 0].tolist() == [4, -32, 0]
    assert got[0, :, 1].tolist() == [-2, -32, 0]
    assert not got[:, :, 2:].any()


def test_block_rows_and_shapes_rejected():
    with pytest.raises(ValueError, match="not a multiple of block_rows"):
        port(XH[:100], XL[:100], POWS)
    with pytest.raises(ValueError, match="not a multiple of block_rows"):
        JK.slice_rows(jnp.asarray(XH[:100]), jnp.asarray(XL[:100]),
                      jnp.asarray(POWS), interpret=True)
    assert port(XH[:100], XL[:100], POWS, block_rows=50).shape == (
        100, 10, 128)
    with pytest.raises(ValueError, match="must be"):
        port(XH, XL[:, :64], POWS)


def test_wrapper_on_cpu():
    """On CPU tensors the wrapper runs its twin, counts no launch, fills
    ``out`` and refuses a CUDA request."""
    args = [torch.from_numpy(a) for a in (XH, XL, POWS)]
    before = TS.launch_counts()
    buf = torch.empty((10, 256, 128), dtype=torch.int8)
    got = TS.slice_rows(*args, row_major=False, out=buf)
    assert got is buf and TS.launch_counts() == before == {
        "slice_rows": before["slice_rows"]}
    assert torch.equal(buf, TS.slice_rows_reference(*args, row_major=False))
    with pytest.raises(ValueError, match="impl='cuda'"):
        TS.slice_rows(*args, impl="cuda")
