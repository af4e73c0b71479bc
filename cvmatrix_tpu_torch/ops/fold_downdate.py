"""The K-fold downdates: plain PyTorch twins, CUDA kernel wrappers, dispatch.

Counterpart of the JAX package's fold-batch kernels
(``cvmatrix_tpu/ops/kernels.py``), each computing, per fold of L validation
rows, the product ``D = Xv_w^T [Xv_u | Yv_u]`` and then one epilogue:

- :func:`fold_packed` ports ``fused_downdate_df64_packed`` for float64
  operands and ``fused_downdate_f32_packed`` for float32 ones (factor
  form, from the prepared streams ``u`` (F, L, K) and ``v`` (F, L, C))::

      out = total (.) (i1 (x) i2) - (sum_l u_l (x) v_l + p (x) q)

- :func:`fold_downdate_f32` ports ``fused_downdate``, the float32 engine's
  kernel for folds of at least 32 rows (reference form, from the
  contiguous streams ``xv`` (F, L, K), weighted and masked, and ``m2``
  (F, L, C), unweighted), in that kernel's order::

      out = ((total - D) - p (x) q) (.) (i1 (x) i2)

- :func:`fold_ozaki_df64` ports ``fused_ozaki_downdate_df64`` and
  :func:`fold_v3` ports ``fused_ozaki_downdate_v3`` (reference form, rows
  gathered by index from the dataset, masked rows zeroed on the weighted
  side)::

      out = (total - D - p (x) q) (.) (i1 (x) i2)

  The v3 kernel derives its per-fold X-side vectors itself (the weighted
  squared sums of the gathered rows, the downdated mean, the clamped
  reciprocal std), from the column sums ``sxv``, the global sums ``gx``,
  the Y-side vectors ``yvec`` and the scalars ``scal``;
  :func:`fold_ozaki_df64` takes ``kvec``/``cvec`` precomputed.
  ``fold_v3(..., sym=True)`` ports ``fused_ozaki_downdate_v3_sym``: the
  X block's upper triangle computed, its strictly lower triangle the
  mirror (twin :func:`v3_sym_reference`). All three run the float64 tile
  on the FP64 tensor cores.
- :func:`fold_smallfold` ports ``fused_smallfold_df64``, the masked
  multi-row LOOCV kernel, on the LOOCV sources in either dtype: the same
  reference form after a vector phase that derives both sides' vectors
  from the fold's gathered rows, the global sums and the scalars alone
  (twin :func:`smallfold_reference`).
- :func:`fold_epilogue` ports ``fused_epilogue_df64``: the reference-form
  epilogue in place over a product computed outside the kernel.

``kvec`` is (F, 2, K) holding ``[p, i1]``, ``cvec`` (F, 2, C) holding
``[q, i2]``: p and q are zero without centring, i1 and i2 one without
scaling, so every epilogue applies all four. The TPU kernels' double-float
pairs, int8 slices and 128-padding are not carried over: the H100 computes
in float64 (or, for the float32 kernels, in float32 on FP32 FMA) on the
unpadded (K, C) shape. Kernels: ``csrc/fold_downdate.cu`` and
``csrc/fold_epilogue.cu``. The twins' float32 products run in full float32
(:func:`~cvmatrix_tpu_torch.ops.precision.highest_precision`).

Every wrapper dispatches like :func:`cvmatrix_tpu_torch.ops.loocv.fused_loocv`:
``impl="auto"`` launches the kernel for CUDA tensors and runs the twin for
CPU tensors; ``"cuda"`` always launches; ``"torch"`` always runs the twin.
:func:`launch_counts` reads each kernel's launches (``<wrapper>.launches``,
``fold_packed.launches_f32`` and ``fold_smallfold.launches_f32`` for the
float32 kernels and ``fold_v3.launches_sym`` for the symmetric v3 kernel).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..utils.profiling import to_device
from .loocv import (
    _FLAG_BITS,
    IMPLS,
    _ptr,
    check_rows,
    mirror_x_block,
    side_stats,
)
from .precision import highest_precision

__all__ = [
    "packed_reference",
    "downdate_f32_reference",
    "ozaki_df64_reference",
    "v3_vectors",
    "v3_reference",
    "v3_sym_reference",
    "smallfold_reference",
    "epilogue_reference",
    "fold_packed",
    "fold_downdate_f32",
    "fold_ozaki_df64",
    "fold_v3",
    "fold_smallfold",
    "fold_epilogue",
    "downdate_f32_splits",
    "device_rows",
    "launch_counts",
    "reset_launch_counts",
]


# --------------------------------------------------------------------------- #
# Plain twins                                                                 #
# --------------------------------------------------------------------------- #


def _pq(kvec, cvec):
    return kvec[:, 0, :, None] * cvec[:, 0, None, :]


def _i12(kvec, cvec):
    return kvec[:, 1, :, None] * cvec[:, 1, None, :]


@highest_precision()
def packed_reference(total, u, v, kvec, cvec) -> torch.Tensor:
    """Factor form: ``total (.) (i1 (x) i2) - (sum_l u_l (x) v_l + p (x) q)``."""
    d = torch.einsum("flk,flc->fkc", u, v)
    return total * _i12(kvec, cvec) - (d + _pq(kvec, cvec))


@highest_precision()
def downdate_f32_reference(total, xv, m2, kvec, cvec) -> torch.Tensor:
    """``fused_downdate``'s reference form in its order:
    ``((total - sum_l xv_l (x) m2_l) - p (x) q) (.) (i1 (x) i2)``."""
    d = torch.einsum("flk,flc->fkc", xv, m2)
    return ((total - d) - _pq(kvec, cvec)) * _i12(kvec, cvec)


def epilogue_reference(total, prod, kvec, cvec) -> torch.Tensor:
    """Reference form: ``(total - prod - p (x) q) (.) (i1 (x) i2)``."""
    return (total - (prod + _pq(kvec, cvec))) * _i12(kvec, cvec)


def _gather(xw, xu, yu, rows, mask, with_x: bool):
    """``(Xv_w, [Xv_u | Yv_u])`` of fold rows (F, L); the mask zeroes the
    weighted side only."""
    a = xw[rows]
    if mask is not None:
        a = a * mask[..., None]
    parts = ([xu[rows]] if with_x else []) + ([yu[rows]] if yu is not None
                                              else [])
    return a, (torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0])


@highest_precision()
def ozaki_df64_reference(total, xw, xu, yu, rows, mask, kvec, cvec, *,
                         with_x: bool = True) -> torch.Tensor:
    """Gather, ``bmm``, reference-form epilogue. ``with_x=False`` drops the
    X columns from the product's right side (the XTY-only batch)."""
    a, b = _gather(xw, xu, yu, rows, mask, with_x)
    return epilogue_reference(total, torch.bmm(a.mT, b), kvec, cvec)


def v3_vectors(xw, xu, rows, mask, gx, sxv, yvec, scal, *, c: int,
               center_xtx: bool, center_xty: bool, scale_x: bool,
               scale_y: bool, with_y: bool, resolution: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The v3 kernel's per-fold ``kvec`` (F, 2, K) and ``cvec`` (F, 2, C).

    X side from the fold's rows: the downdated mean from the column sums
    ``sxv`` and the clamped reciprocal std from the weighted squared sums
    ``sum_l mask xw xu`` (the X-block diagonal of the product, which the
    TPU kernel reads off its product). Y side from ``yvec`` (F, 2, C):
    its Y columns hold the q part and the i2 part.
    """
    center_xty = with_y and center_xty
    center = center_xtx or center_xty
    scale = scale_x or (with_y and scale_y)
    f_folds, k = sxv.shape
    sq = None
    if scale_x:
        a, b = _gather(xw, xu, None, rows, mask, True)
        sq = (a * b).sum(dim=1)
    mx, r1 = side_stats(sxv, sq, gx, scal, need_mean=center,
                        resolution=resolution)
    zeros = torch.zeros_like(sxv)
    p = scal[:, 0:1] * mx if center else zeros
    q = torch.zeros((f_folds, c), dtype=sxv.dtype, device=sxv.device)
    i2 = torch.ones_like(q)
    if center_xtx:
        q[:, :k] = mx
    if center_xty:
        q[:, k:] = yvec[:, 0, k:]
    if scale:
        i2[:, :k] = r1
        i2[:, k:] = yvec[:, 1, k:]
    return torch.stack([p, r1], dim=1), torch.stack([q, i2], dim=1)


def v3_reference(total, xw, xu, yu, rows, mask, gx, sxv, yvec, scal,
                 **flags) -> torch.Tensor:
    """Plain twin of the v3 kernel: its vectors, then gather, ``bmm`` and
    the reference-form epilogue."""
    kvec, cvec = v3_vectors(xw, xu, rows, mask, gx, sxv, yvec, scal,
                            c=total.shape[1], **flags)
    return ozaki_df64_reference(total, xw, xu, yu, rows, mask, kvec, cvec)


def v3_sym_reference(*args, **flags) -> torch.Tensor:
    """Plain twin of the symmetric v3 kernel: :func:`v3_reference`, then
    the X block's strictly lower triangle written as its upper mirror."""
    return mirror_x_block(v3_reference(*args, **flags))


def smallfold_reference(total, xw, xu, yu, yw, rows, mask, gx, gy, scal, *,
                        center_xtx: bool, center_xty: bool, scale_x: bool,
                        scale_y: bool, with_y: bool,
                        resolution: float) -> torch.Tensor:
    """Plain twin of the small-fold kernel (port of ``fused_smallfold_df64``).

    The fold's L rows gathered, the masked weighted column sums ``sxv`` of
    the X side, and the Y side's downdated mean and clamped reciprocal std
    from its masked weighted sums and squared sums (``gy`` the (2, M)
    global ``[sum_Y, sum_sq_Y]``) in place of v3's ``yvec``; then
    :func:`v3_reference`: v3's X-side vectors, gather, ``bmm`` and the
    reference-form epilogue. The mask multiplies the weighted side only.
    """
    flags = dict(center_xtx=center_xtx, center_xty=center_xty,
                 scale_x=scale_x, scale_y=scale_y, with_y=with_y,
                 resolution=resolution)
    k = xw.shape[1]
    sxv = _gather(xw, xu, None, rows, mask, True)[0].sum(dim=1)
    yvec = sxv.new_zeros((rows.shape[0], 2, total.shape[1]))
    yvec[:, 1] = 1.0  # i2's Y part where Y is not scaled
    if with_y and (center_xty or scale_y):
        b, u = _gather(yw, yu, None, rows, mask, True)
        yvec[:, 0, k:], yvec[:, 1, k:] = side_stats(
            b.sum(dim=1), (b * u).sum(dim=1) if scale_y else None, gy, scal,
            need_mean=True, resolution=resolution)
    return v3_reference(total, xw, xu, yu if with_y else None, rows, mask,
                        gx, sxv, yvec, scal, **flags)


# --------------------------------------------------------------------------- #
# Dispatch and launches                                                       #
# --------------------------------------------------------------------------- #


def _use_kernel(name: str, impl: str, device: torch.device) -> bool:
    """True to launch the kernel, False to run the twin (see module doc)."""
    if impl not in IMPLS:
        raise ValueError(f"Unknown impl: {impl!r} (auto|cuda|torch).")
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(
            f"impl='cuda' needs CUDA tensors; the operands are on {device}."
        )
    if impl == "torch" or (impl == "auto" and device.type == "cpu"):
        return False
    if device.type != "cuda":
        raise ValueError(f"{name} has no kernel for device {device}.")
    return True


def _check(name: str, device, tensors, dtype) -> None:
    for t in tensors:
        if t is None:
            continue
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name} operands must be {dtype} on {device}; "
                             f"got {t.dtype} on {t.device}.")
        if not t.is_contiguous():
            raise ValueError(f"{name} operands must be contiguous.")


def _shape(name: str, t, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}.")


def _out(name: str, out, shape, device, dtype) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=dtype, device=device)
    if (tuple(out.shape) != tuple(shape) or out.dtype != dtype
            or out.device != device or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be a contiguous {dtype} "
                         f"{tuple(shape)} tensor on {device}.")
    return out


def device_rows(rows, n: int, device) -> torch.Tensor:
    """Fold rows (F, L) as int64 on ``device``. Host rows are range-checked
    here; device rows pass unchecked (a check here would stall the stream
    once per chunk): the entries that take them check them, ``core/batch``'s
    operand builders once per call and ``smallfold_from_sources`` once per
    sources (``LoocvSources.rows``)."""
    if isinstance(rows, torch.Tensor) and rows.device.type != "cpu":
        if rows.dtype != torch.int64 or rows.ndim != 2:
            raise ValueError("device fold rows must be an (F, L) int64 "
                             "tensor.")
        return rows.contiguous()
    r = torch.as_tensor(rows)
    if r.ndim != 2:
        raise ValueError(f"fold rows must be (F, L), got {tuple(r.shape)}.")
    checked = check_rows(r, n).reshape(r.shape)
    if isinstance(rows, torch.Tensor) and rows.device == torch.device(device):
        return checked  # on the CPU: the twins' own rows, nothing to move
    return to_device(checked, device)


def _fn(lib_name: str, fn_name: str, n_ptr: int, n_int: int, tail=()):
    from . import _build

    fn = getattr(_build.load_library(lib_name), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int64] * n_int
                   + list(tail) + [ctypes.c_int, ctypes.c_void_p])
    return fn


def _run(name: str, fn, *args, device) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*args, device.index, ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def _streams(name, total, a, b, kvec, cvec, out, dtype):
    """Check the (F, L, K) and (F, L, C) stream operands of a tile kernel
    -> the (F, K, C) output and ``(F, L, K, C)``."""
    device = a.device
    f_folds, n_l, k = a.shape
    c = total.shape[1]
    _check(name, device, (total, a, b, kvec, cvec), dtype)
    _shape(f"{name} total", total, (k, c))
    _shape(f"{name} streams", b, (f_folds, n_l, c))
    _shape(f"{name} kvec", kvec, (f_folds, 2, k))
    _shape(f"{name} cvec", cvec, (f_folds, 2, c))
    return _out(name, out, (f_folds, k, c), device, dtype), (f_folds, n_l, k,
                                                              c)


# The float32 stream tile of ``cvm_fold_downdate_f32``: its output tile
# edge and the blocks an SM holds (constants of csrc/fold_downdate.cu), and
# the split rule's limits: at most 8 blocks share a fold's rows, each at
# least 512 of them.
_F32_TILE = 128
_F32_BLOCKS_PER_SM = 2
_F32_MAX_SPLITS = 8
_F32_MIN_SPLIT_ROWS = 512


def downdate_f32_splits(f_folds: int, k: int, c: int, n_l: int,
                        n_sm: int) -> int:
    """How many blocks share each fold's L rows in ``fold_downdate_f32``'s
    kernel (1: no split).

    A batch whose 128 x 128 tiles fill two waves of the card (2 blocks an
    SM) or more is not split. Otherwise S in 1 .. 8 is the one that
    minimises the rows the busiest SM multiplies, ``ceil(tiles S / SMs)
    ceil(L / S)`` (the smallest S on ties), among splits of at least 512
    rows. At K=500, C=510 on 132 SMs: three folds of 33,334 rows (P=3) give
    8; 500 folds of 100 rows (P=1,000) give 1.
    """
    tiles = f_folds * -(-k // _F32_TILE) * -(-c // _F32_TILE)
    if tiles >= 2 * n_sm * _F32_BLOCKS_PER_SM:
        return 1
    best, best_rows = 1, -(-tiles // n_sm) * n_l
    for s in range(2, _F32_MAX_SPLITS + 1):
        per = -(-n_l // s)
        if per < _F32_MIN_SPLIT_ROWS:
            break
        rows = -(-tiles * s // n_sm) * per
        if rows < best_rows:
            best, best_rows = s, rows
    return best


def fold_packed(total, u, v, kvec, cvec, *, impl: str = "auto",
                out=None) -> torch.Tensor:
    """Factor-form downdate of the prepared streams -> (F, K, C), in the
    operands' dtype (all float64 or all float32)."""
    if not _use_kernel("fold_packed", impl, u.device):
        res = packed_reference(total, u, v, kvec, cvec)
        return res if out is None else out.copy_(res)
    f32 = u.dtype == torch.float32
    out, dims = _streams("fold_packed", total, u, v, kvec, cvec, out,
                         torch.float32 if f32 else torch.float64)
    fn = _fn("fold_downdate",
             "cvm_fold_packed_f32" if f32 else "cvm_fold_packed_f64", 6, 4)
    _run("fold_packed", fn, _ptr(total), _ptr(u), _ptr(v), _ptr(kvec),
         _ptr(cvec), _ptr(out), *dims, device=u.device)
    if f32:
        fold_packed.launches_f32 += 1
    else:
        fold_packed.launches += 1
    return out


def fold_downdate_f32(total, xv, m2, kvec, cvec, *, impl: str = "auto",
                      out=None) -> torch.Tensor:
    """``fused_downdate``'s reference-form downdate of the float32 streams
    ``xv`` (F, L, K) and ``m2`` (F, L, C) -> (F, K, C) float32.

    On the card, a batch of few large folds shares each fold's rows among
    :func:`downdate_f32_splits` blocks, whose partial products go to an
    (S, F, K, C) workspace that a second kernel sums in a fixed order; the
    call still counts one launch."""
    if not _use_kernel("fold_downdate_f32", impl, xv.device):
        res = downdate_f32_reference(total, xv, m2, kvec, cvec)
        return res if out is None else out.copy_(res)
    device = xv.device
    out, (f_folds, n_l, k, c) = _streams("fold_downdate_f32", total, xv, m2,
                                         kvec, cvec, out, torch.float32)
    splits = downdate_f32_splits(
        f_folds, k, c, n_l,
        torch.cuda.get_device_properties(device).multi_processor_count)
    work = (torch.empty((splits, f_folds, k, c), dtype=torch.float32,
                        device=device) if splits > 1 else None)
    fn = _fn("fold_downdate", "cvm_fold_downdate_f32", 7, 5)
    _run("fold_downdate_f32", fn, _ptr(total), _ptr(xv), _ptr(m2),
         _ptr(kvec), _ptr(cvec), _ptr(out), _ptr(work), f_folds, n_l, k, c,
         splits, device=device)
    fold_downdate_f32.launches += 1
    return out


def _gather_operands(name, total, xw, xu, yu, rows, mask, with_x,
                     dtype=torch.float64):
    """Checked shapes ``(rows, F, L, K, KX, M, C)`` of a gather kernel."""
    device = xw.device
    n, k = xw.shape
    m = 0 if yu is None else yu.shape[1]
    kx = k if with_x else 0
    c = kx + m
    rows = device_rows(rows, n, device)
    f_folds, n_l = rows.shape
    _check(name, device, (total, xw, xu if with_x else None, yu, mask),
           dtype)
    _shape(f"{name} total", total, (k, c))
    if with_x:
        _shape(f"{name} xu", xu, (n, k))
    if yu is not None:
        _shape(f"{name} yu", yu, (n, m))
    if mask is not None:
        _shape(f"{name} mask", mask, (f_folds, n_l))
    if c == 0:
        raise ValueError(f"{name}: the product has no columns.")
    return rows, f_folds, n_l, k, kx, m, c


def fold_ozaki_df64(total, xw, xu, yu, rows, mask, kvec, cvec, *,
                    with_x: bool = True, impl: str = "auto",
                    out=None) -> torch.Tensor:
    """Gathered product plus reference-form epilogue -> (F, K, C).

    ``xw``/``xu`` are the (N, K) weighted and unweighted X rows, ``yu`` the
    (N, M) Y rows or ``None``; ``rows`` the (F, L) fold rows and ``mask``
    an optional (F, L) 0/1 float64 mask. ``with_x=False`` leaves the X
    columns out of the output (C = M).
    """
    device = xw.device
    if not _use_kernel("fold_ozaki_df64", impl, device):
        rows = device_rows(rows, xw.shape[0], device)
        res = ozaki_df64_reference(total, xw, xu, yu, rows, mask, kvec, cvec,
                                   with_x=with_x)
        return res if out is None else out.copy_(res)
    rows, f_folds, n_l, k, kx, m, c = _gather_operands(
        "fold_ozaki_df64", total, xw, xu, yu, rows, mask, with_x)
    _check("fold_ozaki_df64", device, (kvec, cvec), torch.float64)
    _shape("fold_ozaki_df64 kvec", kvec, (f_folds, 2, k))
    _shape("fold_ozaki_df64 cvec", cvec, (f_folds, 2, c))
    out = _out("fold_ozaki_df64", out, (f_folds, k, c), device,
               torch.float64)
    fn = _fn("fold_downdate", "cvm_fold_ozaki_df64_f64", 9, 5)
    _run("fold_ozaki_df64", fn, _ptr(total), _ptr(xw),
         _ptr(xu if with_x else None), _ptr(yu), _ptr(rows), _ptr(mask),
         _ptr(kvec), _ptr(cvec), _ptr(out), f_folds, n_l, k, kx, m,
         device=device)
    fold_ozaki_df64.launches += 1
    return out


def fold_v3(total, xw, xu, yu, rows, mask, gx, sxv, yvec, scal, *,
            center_xtx: bool, center_xty: bool, scale_x: bool,
            scale_y: bool, with_y: bool, resolution: float,
            sym: bool = False, impl: str = "auto",
            out=None) -> torch.Tensor:
    """The v3 downdate -> (F, K, C): per-fold X-side vectors from the
    gathered rows (see :func:`v3_vectors`), then the gathered product and
    the reference-form epilogue. ``gx`` is (2, K) ``[sum_X, sum_sq_X]``,
    ``sxv`` (F, K), ``yvec`` (F, 2, C), ``scal`` (F, 3). ``sym`` computes
    the X block's upper triangle only and mirrors it (exactly symmetric);
    its launches count in ``fold_v3.launches_sym``."""
    flags = dict(center_xtx=center_xtx, center_xty=center_xty,
                 scale_x=scale_x, scale_y=scale_y, with_y=with_y,
                 resolution=resolution)
    device = xw.device
    if not _use_kernel("fold_v3", impl, device):
        rows = device_rows(rows, xw.shape[0], device)
        twin = v3_sym_reference if sym else v3_reference
        res = twin(total, xw, xu, yu if with_y else None, rows, mask, gx,
                   sxv, yvec, scal, **flags)
        return res if out is None else out.copy_(res)
    rows, f_folds, n_l, k, _, m, c = _gather_operands(
        "fold_v3", total, xw, xu, yu if with_y else None, rows, mask, True)
    _check("fold_v3", device, (gx, sxv, yvec, scal), torch.float64)
    _shape("fold_v3 gx", gx, (2, k))
    _shape("fold_v3 sxv", sxv, (f_folds, k))
    _shape("fold_v3 yvec", yvec, (f_folds, 2, c))
    _shape("fold_v3 scal", scal, (f_folds, 3))
    out = _out("fold_v3", out, (f_folds, k, c), device, torch.float64)
    kvec = torch.empty((f_folds, 2, k), dtype=torch.float64, device=device)
    cvec = torch.empty((f_folds, 2, c), dtype=torch.float64, device=device)
    bits = sum(b for name, b in _FLAG_BITS.items() if flags[name])
    fn = _fn("fold_downdate", "cvm_fold_v3_f64", 13, 4,
             tail=(ctypes.c_int, ctypes.c_double, ctypes.c_int))
    _run("fold_v3", fn, _ptr(total), _ptr(xw), _ptr(xu),
         _ptr(yu if with_y else None), _ptr(rows), _ptr(mask), _ptr(gx),
         _ptr(sxv), _ptr(yvec), _ptr(scal), _ptr(kvec), _ptr(cvec),
         _ptr(out), f_folds, n_l, k, m, bits, float(resolution), int(sym),
         device=device)
    if sym:
        fold_v3.launches_sym += 1
    else:
        fold_v3.launches += 1
    return out


_SMALLFOLD_KERNELS = {torch.float64: ("cvm_fold_smallfold_f64", "launches"),
                      torch.float32: ("cvm_fold_smallfold_f32",
                                      "launches_f32")}


def fold_smallfold(total, xw, xu, yu, yw, gx, gy, rows, mask, scal, *,
                   center_xtx: bool, center_xty: bool, scale_x: bool,
                   scale_y: bool, with_y: bool, resolution: float,
                   impl: str = "auto", out=None) -> torch.Tensor:
    """The small-fold downdate of gathered rows -> (F, K, C), the port of
    ``fused_smallfold_df64`` (twin :func:`smallfold_reference`).

    Operands as in :class:`cvmatrix_tpu_torch.core.batch.LoocvSources`:
    ``total`` (K, C), ``xw``/``xu`` (N, K), ``yu``/``yw`` (N, M) and ``gy``
    (2, M) (``None`` or ignored without ``with_y``), ``gx`` (2, K), ``rows``
    (F, L), ``mask`` (F, L) or ``None``, ``scal`` (F, 3); all float64, or
    all float32 (the kernel then computes in float32). Launches count in
    ``fold_smallfold.launches`` and, in float32, ``.launches_f32``."""
    flags = dict(center_xtx=center_xtx, center_xty=center_xty,
                 scale_x=scale_x, scale_y=scale_y, with_y=with_y,
                 resolution=resolution)
    device = xw.device
    if not with_y:
        yu = yw = gy = None
    if not _use_kernel("fold_smallfold", impl, device):
        rows = device_rows(rows, xw.shape[0], device)
        res = smallfold_reference(total, xw, xu, yu, yw, rows, mask, gx, gy,
                                  scal, **flags)
        return res if out is None else out.copy_(res)
    if xw.dtype not in _SMALLFOLD_KERNELS:
        raise ValueError(f"fold_smallfold has no kernel for {xw.dtype}.")
    entry, counter = _SMALLFOLD_KERNELS[xw.dtype]
    rows, f_folds, n_l, k, _, m, c = _gather_operands(
        "fold_smallfold", total, xw, xu, yu, rows, mask, True, xw.dtype)
    _check("fold_smallfold", device, (yw, gx, gy, scal), xw.dtype)
    _shape("fold_smallfold gx", gx, (2, k))
    if with_y:
        _shape("fold_smallfold yw", yw, yu.shape)
        _shape("fold_smallfold gy", gy, (2, m))
    _shape("fold_smallfold scal", scal, (f_folds, 3))
    out = _out("fold_smallfold", out, (f_folds, k, c), device, xw.dtype)
    kvec = torch.empty((f_folds, 2, k), dtype=xw.dtype, device=device)
    cvec = torch.empty((f_folds, 2, c), dtype=xw.dtype, device=device)
    bits = sum(b for name, b in _FLAG_BITS.items() if flags[name])
    fn = _fn("fold_downdate", entry, 13, 4,
             tail=(ctypes.c_int, ctypes.c_double))
    _run("fold_smallfold", fn, _ptr(total), _ptr(xw), _ptr(xu), _ptr(yu),
         _ptr(yw), _ptr(rows), _ptr(mask), _ptr(gx), _ptr(gy), _ptr(scal),
         _ptr(kvec), _ptr(cvec), _ptr(out), f_folds, n_l, k, m, bits,
         float(resolution), device=device)
    setattr(fold_smallfold, counter, getattr(fold_smallfold, counter) + 1)
    return out


def fold_epilogue(total, prod, kvec, cvec, *,
                  impl: str = "auto") -> torch.Tensor:
    """Reference-form epilogue written in place into ``prod`` (F, K, C),
    which is returned (the JAX kernel aliases its output to the product)."""
    device = prod.device
    if not _use_kernel("fold_epilogue", impl, device):
        return prod.copy_(epilogue_reference(total, prod, kvec, cvec))
    f_folds, k, c = prod.shape
    _check("fold_epilogue", device, (total, prod, kvec, cvec),
           torch.float64)
    _shape("fold_epilogue total", total, (k, c))
    _shape("fold_epilogue kvec", kvec, (f_folds, 2, k))
    _shape("fold_epilogue cvec", cvec, (f_folds, 2, c))
    fn = _fn("fold_epilogue", "cvm_fold_epilogue_f64", 4, 3)
    _run("fold_epilogue", fn, _ptr(total), _ptr(prod), _ptr(kvec),
         _ptr(cvec), f_folds, k, c, device=device)
    fold_epilogue.launches += 1
    return prod


# kernel -> (wrapper, the attribute that counts its launches)
_COUNTERS = {
    "fold_packed": (fold_packed, "launches"),
    "fold_packed_f32": (fold_packed, "launches_f32"),
    "fold_downdate_f32": (fold_downdate_f32, "launches"),
    "fold_ozaki_df64": (fold_ozaki_df64, "launches"),
    "fold_v3": (fold_v3, "launches"),
    "fold_v3_sym": (fold_v3, "launches_sym"),
    "fold_epilogue": (fold_epilogue, "launches"),
    "fold_smallfold": (fold_smallfold, "launches"),
    "fold_smallfold_f32": (fold_smallfold, "launches_f32"),
}


def reset_launch_counts() -> None:
    for wrapper, attr in _COUNTERS.values():
        setattr(wrapper, attr, 0)


def launch_counts() -> dict:
    """``{kernel: launches}`` of the nine fold kernels."""
    return {name: getattr(wrapper, attr)
            for name, (wrapper, attr) in _COUNTERS.items()}


reset_launch_counts()
