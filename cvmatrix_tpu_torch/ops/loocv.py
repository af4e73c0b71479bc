"""The LOOCV downdate: plain PyTorch twin, CUDA kernel wrapper, dispatch.

Counterpart of the JAX package's ``fused_loocv_df64`` family
(``cvmatrix_tpu/ops/kernels.py``: ``_loocv_vectors``, ``_loocv_fold_math``,
``fused_loocv_df64_reference`` and the Pallas call ``fused_loocv_df64``)
and of its float32 sibling ``fused_loocv_f32`` (``_f32_loocv_body``).
Per fold with validation row ``r`` and per-fold scalars
``scal[f] = (sw, 1/sw, 1/divisor)``::

    out[f] = total (.) (r1 (x) rc) - u (x) v - p (x) q          (K, C)

where ``rc = [r1 | r2]`` are clamped reciprocal training stds (1 on a side
that is not scaled), ``u = xw[r] r1``, ``v = [xu[r] r1 | yu[r] r2]``,
``p = sw mX r1`` and ``q = [mX r1 | mY r2]`` (zeroed where that side is not
centred). See ``cvmatrix_tpu_torch/csrc/loocv.cu`` for the kernels:
``cvm_loocv_f64`` for float64 sources and ``cvm_loocv_f32`` for float32
ones, each computing in its sources' dtype.

:func:`fused_loocv` dispatches: ``impl="auto"`` launches the kernel for CUDA
tensors and runs :func:`loocv_reference` for CPU tensors; ``"cuda"`` always
launches (and raises for CPU tensors); ``"torch"`` always runs the twin.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

__all__ = ["loocv_vectors", "loocv_reference", "fused_loocv",
           "check_rows", "IMPLS"]

IMPLS = ("auto", "cuda", "torch")

_FLAG_BITS = {"center_xtx": 1, "center_xty": 2, "scale_x": 4, "scale_y": 8,
              "with_y": 16}


def check_rows(rows, n: int) -> torch.Tensor:
    """Fold rows as an int64 tensor, range-checked against ``[0, n)``.

    A CUDA gather out of range reads out of bounds (the JAX kernel clamps
    under jit), so the check runs before every launch: on the host for a
    CPU tensor or array, with one device sync for a CUDA tensor.
    """
    rows = torch.as_tensor(rows)
    if rows.dtype not in (torch.int64, torch.int32):
        raise TypeError(f"fold rows must be int32/int64, got {rows.dtype}")
    rows = rows.reshape(-1).to(torch.int64)
    if rows.numel():
        lo, hi = (int(x) for x in torch.aminmax(rows))
        if lo < 0 or hi >= n:
            raise ValueError(
                f"fold rows outside [0, {n}) (min {lo}, max {hi})."
            )
    return rows


def loocv_vectors(src, rows: torch.Tensor, scal: torch.Tensor, *,
                  center_xtx: bool, center_xty: bool, scale_x: bool,
                  scale_y: bool, with_y: bool, resolution: float
                  ) -> Tuple[torch.Tensor, ...]:
    """The per-fold vectors ``(rc, u, v, p, q)``: (F, C), (F, K), (F, C),
    (F, K), (F, C). The kernel's vector phase computes the same."""
    center_xty = with_y and center_xty
    scale_y = with_y and scale_y
    center = center_xtx or center_xty
    sw, rsw, rdv = scal[:, 0:1], scal[:, 1:2], scal[:, 2:3]

    def side(w_rows, u_rows, g, need_mean, need_std):
        m = torch.zeros_like(w_rows)
        r = torch.ones_like(w_rows)
        if need_mean or need_std:
            st = g[0] - w_rows
            m = st * rsw
            if need_std:
                ss = g[1] - w_rows * u_rows
                var = (-2.0 * m * st + sw * (m * m) + ss) * rdv
                sd = torch.sqrt(torch.clamp(var, min=0.0))
                r = torch.where(sd <= resolution, torch.ones_like(sd), 1.0 / sd)
        return m, r

    xw_r, xu_r = src.xw[rows], src.xu[rows]
    mX, r1 = side(xw_r, xu_r, src.gx, center or scale_x, scale_x)
    mr = mX * r1
    u = xw_r * r1
    v = xu_r * r1
    p = sw * mr if center else torch.zeros_like(mr)
    q = mr if center_xtx else torch.zeros_like(mr)
    rc = r1
    if with_y:
        yw_r, yu_r = src.yw[rows], src.yu[rows]
        mY, r2 = side(yw_r, yu_r, src.gy, center_xty or scale_y, scale_y)
        rc = torch.cat([r1, r2], dim=1)
        v = torch.cat([v, yu_r * r2], dim=1)
        q = torch.cat([q, mY * r2 if center_xty else torch.zeros_like(mY)],
                      dim=1)
    return rc, u, v, p, q


def loocv_reference(src, rows: torch.Tensor, scal: torch.Tensor, *,
                    center_xtx: bool, center_xty: bool, scale_x: bool,
                    scale_y: bool, with_y: bool, resolution: float
                    ) -> torch.Tensor:
    """Plain-torch twin of the kernel: (F, K, C) in the sources' dtype."""
    rc, u, v, p, q = loocv_vectors(
        src, rows, scal, center_xtx=center_xtx, center_xty=center_xty,
        scale_x=scale_x, scale_y=scale_y, with_y=with_y,
        resolution=resolution,
    )
    k = u.shape[1]
    return (src.total * (rc[:, :k, None] * rc[:, None, :])
            - u[:, :, None] * v[:, None, :] - p[:, :, None] * q[:, None, :])


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


_KERNELS = {torch.float64: "cvm_loocv_f64", torch.float32: "cvm_loocv_f32"}


def _launch(src, rows, scal, out, flags: int, resolution: float) -> None:
    from . import _build

    fn = getattr(_build.load_library("loocv"), _KERNELS[out.dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11
                   + [ctypes.c_int64] * 3
                   + [ctypes.c_int, ctypes.c_double, ctypes.c_int,
                      ctypes.c_void_p])
    f_folds, k, c = out.shape
    m = c - k
    vec = torch.empty((f_folds, 5, c), dtype=out.dtype, device=out.device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = fn(_ptr(rows), _ptr(src.total), _ptr(src.xw), _ptr(src.xu),
             _ptr(src.yu), _ptr(src.yw), _ptr(src.gx), _ptr(src.gy),
             _ptr(scal), _ptr(vec), _ptr(out), f_folds, k, m, flags,
             float(resolution), out.device.index, ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"fused_loocv: CUDA launch failed (cudaError {err})")


def fused_loocv(src, rows, scal: torch.Tensor, *, center_xtx: bool,
                center_xty: bool, scale_x: bool, scale_y: bool,
                with_y: bool, resolution: float, impl: str = "auto",
                out=None) -> torch.Tensor:
    """All-in-one LOOCV downdate of fold rows ``rows`` -> (F, K, C).

    ``src`` holds the dataset-wide operands (see
    :class:`cvmatrix_tpu_torch.core.batch.LoocvSources`); ``scal`` the
    (F, 3) per-fold scalars; every operand float64, or every operand
    float32. ``out``, when given, is a contiguous (F, K, C) buffer of that
    dtype that receives the result. ``fused_loocv.launches`` counts the
    float64 kernel's launches and ``fused_loocv.launches_f32`` the float32
    kernel's.
    """
    if impl not in IMPLS:
        raise ValueError(f"Unknown impl: {impl!r} (auto|cuda|torch).")
    device = src.xw.device
    rows = check_rows(rows, src.xw.shape[0])
    flags = dict(center_xtx=center_xtx, center_xty=center_xty,
                 scale_x=scale_x, scale_y=scale_y, with_y=with_y,
                 resolution=resolution)
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(
            f"impl='cuda' needs CUDA tensors; the sources are on {device}."
        )
    if impl == "torch" or (impl == "auto" and device.type == "cpu"):
        res = loocv_reference(src, rows.to(device), scal, **flags)
        if out is None:
            return res
        return out.copy_(res)
    if device.type != "cuda":
        raise ValueError(f"fused_loocv has no kernel for device {device}.")
    dtype = src.xw.dtype
    if dtype not in _KERNELS:
        raise ValueError(f"fused_loocv has no kernel for {dtype}.")

    f_folds, (k, c) = rows.shape[0], src.total.shape
    m = c - k
    if c > 1024:  # the single-tile gate; the kernel's shared memory
        raise ValueError(
            f"[X|Y] width {c} > 1024 leaves the LOOCV route; check "
            "loocv_single_tile_ok (the packed route takes such folds)."
        )
    operands = [src.total, src.xw, src.xu, src.gx, scal]
    if with_y:
        operands += [src.yu, src.yw, src.gy]
    elif m:
        raise ValueError("with_y=False needs XTX-only sources (C == K).")
    for t in operands:
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"fused_loocv operands must all be {dtype} on "
                             f"{device}.")
        if not t.is_contiguous():
            raise ValueError("fused_loocv operands must be contiguous.")
    if scal.shape != (f_folds, 3):
        raise ValueError(f"scal must be ({f_folds}, 3), got {tuple(scal.shape)}")
    if out is None:
        out = torch.empty((f_folds, k, c), dtype=dtype, device=device)
    elif (out.shape != (f_folds, k, c) or out.dtype != dtype
          or out.device != device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {dtype} ({f_folds}, {k}, "
                         f"{c}) tensor on {device}.")
    bits = sum(b for name, b in _FLAG_BITS.items() if flags[name])
    _launch(src, rows.to(device, non_blocking=True), scal, out, bits,
            resolution)
    if dtype == torch.float64:
        fused_loocv.launches += 1
    else:
        fused_loocv.launches_f32 += 1
    return out


fused_loocv.launches = 0
fused_loocv.launches_f32 = 0
