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
ones, each computing in its sources' dtype, one or two folds per block (the
latter the ports of ``fused_loocv_df64x2`` and ``fused_loocv_f32x2``), and
``cvm_loocv_sym_f64`` (``sym=True``), the port of ``fused_loocv_df64_sym``:
the upper triangle of the X block computed, ``out[f, j, i] = out[f, i, j]``
for ``i < j < K``, every XTY column computed (twin
:func:`loocv_sym_reference`). Asked for them (``return_stats``), the
kernels' vector phase also stores each fold's training statistics, (F, 2,
C): the means in row 0 and the clamped stds of ``core/fold._train_std`` in
row 1, X in columns ``[0, K)`` and Y in ``[K, C)``; the twins return the
same.

:func:`fused_loocv` dispatches: ``impl="auto"`` launches the kernel for CUDA
tensors and runs :func:`loocv_reference` for CPU tensors; ``"cuda"`` always
launches (and raises for CPU tensors); ``"torch"`` always runs the twin.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..utils.profiling import to_device

__all__ = ["side_mean_std", "side_stats", "loocv_vectors", "loocv_reference",
           "loocv_sym_reference", "mirror_x_block", "fused_loocv",
           "check_rows", "shares_storage", "launch_counts",
           "reset_launch_counts", "IMPLS"]

IMPLS = ("auto", "cuda", "torch")

_FLAG_BITS = {"center_xtx": 1, "center_xty": 2, "scale_x": 4, "scale_y": 8,
              "with_y": 16}


def check_rows(rows, n: int) -> torch.Tensor:
    """Fold rows as an int64 tensor, range-checked against ``[0, n)``.

    A CUDA gather out of range reads out of bounds (the JAX kernel clamps
    under jit), so the check runs before every launch: on the host for a
    CPU tensor or array, with one device sync for a CUDA tensor. Host rows
    take NumPy's single-threaded reduction: torch's multithreaded
    ``aminmax`` of 98,000-100,000 host rows held the card idle 1.7-8 ms a
    call on the H100 machine's shared host, and its wait varied from run
    to run.
    """
    rows = torch.as_tensor(rows)
    if rows.dtype not in (torch.int64, torch.int32):
        raise TypeError(f"fold rows must be int32/int64, got {rows.dtype}")
    rows = rows.reshape(-1).to(torch.int64)
    if rows.numel():
        if rows.is_cpu:
            host = rows.numpy()
            lo, hi = int(host.min()), int(host.max())
        else:
            lo, hi = (int(x) for x in torch.aminmax(rows))
        if lo < 0 or hi >= n:
            raise ValueError(
                f"fold rows outside [0, {n}) (min {lo}, max {hi})."
            )
    return rows


def shares_storage(rows, checked) -> bool:
    """Whether ``rows`` is a tensor view of the ``checked`` tensor's
    storage, of its dtype: rows checked already (``LoocvSources.rows`` and
    slices of it), which the kernel routes take without checking them
    again, so that no chunk syncs the device."""
    return (isinstance(rows, torch.Tensor) and checked is not None
            and rows.device == checked.device and rows.dtype == checked.dtype
            and rows.untyped_storage().data_ptr()
            == checked.untyped_storage().data_ptr())


def side_mean_std(sums, sq, g, scal, *, need_mean: bool, resolution: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Downdated mean and clamped std of one side, (F, W) each.

    ``sums`` (F, W) are the fold's weighted (and masked) row sums, ``sq``
    their squared sums against the unweighted rows or ``None`` where the
    side is not scaled, ``g`` the (2, W) global ``[sum, sum_sq]``, ``scal``
    the (F, 3) ``[sw, 1/sw, 1/divisor]``; the formulas of
    ``core/fold._train_std``. The mean is 0 where neither is needed and
    the std 1 where ``sq`` is ``None`` or the std is at most
    ``resolution``; NaN passes the clamp.
    """
    sw, rsw, rdv = scal[:, 0:1], scal[:, 1:2], scal[:, 2:3]
    m = torch.zeros_like(sums)
    sd = torch.ones_like(sums)
    if need_mean or sq is not None:
        st = g[0] - sums
        m = st * rsw
        if sq is not None:
            ss = g[1] - sq
            var = (-2.0 * m * st + sw * (m * m) + ss) * rdv
            sd = torch.sqrt(torch.clamp(var, min=0.0))
            sd = torch.where(sd <= resolution, torch.ones_like(sd), sd)
    return m, sd


def side_stats(sums, sq, g, scal, *, need_mean: bool, resolution: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Downdated mean and clamped reciprocal std of one side, (F, W) each:
    :func:`side_mean_std` with the std's reciprocal (1 where the std is
    clamped to 1)."""
    m, sd = side_mean_std(sums, sq, g, scal, need_mean=need_mean,
                          resolution=resolution)
    return m, 1.0 / sd


def loocv_vectors(src, rows: torch.Tensor, scal: torch.Tensor, *,
                  center_xtx: bool, center_xty: bool, scale_x: bool,
                  scale_y: bool, with_y: bool, resolution: float,
                  return_stats: bool = False) -> Tuple[torch.Tensor, ...]:
    """The per-fold vectors ``(rc, u, v, p, q)``: (F, C), (F, K), (F, C),
    (F, K), (F, C). The kernel's vector phase computes the same, and with
    ``return_stats`` the (F, 2, C) statistics it stores, appended."""
    center_xty = with_y and center_xty
    scale_y = with_y and scale_y
    center = center_xtx or center_xty
    sw = scal[:, 0:1]

    def side(w_rows, u_rows, g, need_mean, need_std):
        return side_mean_std(w_rows, w_rows * u_rows if need_std else None,
                             g, scal, need_mean=need_mean,
                             resolution=resolution)

    xw_r, xu_r = src.xw[rows], src.xu[rows]
    mX, sX = side(xw_r, xu_r, src.gx, center or scale_x, scale_x)
    r1 = 1.0 / sX
    mr = mX * r1
    u = xw_r * r1
    v = xu_r * r1
    p = sw * mr if center else torch.zeros_like(mr)
    q = mr if center_xtx else torch.zeros_like(mr)
    rc, mean, std = r1, mX, sX
    if with_y:
        yw_r, yu_r = src.yw[rows], src.yu[rows]
        mY, sY = side(yw_r, yu_r, src.gy, center_xty or scale_y, scale_y)
        r2 = 1.0 / sY
        rc = torch.cat([r1, r2], dim=1)
        v = torch.cat([v, yu_r * r2], dim=1)
        q = torch.cat([q, mY * r2 if center_xty else torch.zeros_like(mY)],
                      dim=1)
        mean, std = torch.cat([mX, mY], dim=1), torch.cat([sX, sY], dim=1)
    if return_stats:
        return rc, u, v, p, q, torch.stack([mean, std], dim=1)
    return rc, u, v, p, q


def loocv_reference(src, rows: torch.Tensor, scal: torch.Tensor, *,
                    center_xtx: bool, center_xty: bool, scale_x: bool,
                    scale_y: bool, with_y: bool, resolution: float,
                    return_stats: bool = False):
    """Plain-torch twin of the kernel: (F, K, C) in the sources' dtype, and
    with ``return_stats`` the (F, 2, C) statistics beside it."""
    rc, u, v, p, q, *stats = loocv_vectors(
        src, rows, scal, center_xtx=center_xtx, center_xty=center_xty,
        scale_x=scale_x, scale_y=scale_y, with_y=with_y,
        resolution=resolution, return_stats=return_stats,
    )
    k = u.shape[1]
    out = (src.total * (rc[:, :k, None] * rc[:, None, :])
           - u[:, :, None] * v[:, None, :] - p[:, :, None] * q[:, None, :])
    return (out, *stats) if return_stats else out


def mirror_x_block(out: torch.Tensor) -> torch.Tensor:
    """Write the strictly lower triangle of each fold's X block (the first
    K columns of (F, K, C)) as the transpose of its upper triangle, in
    place: ``out[f, j, i] = out[f, i, j]`` for ``i < j < K``."""
    k = out.shape[1]
    x = out[:, :, :k]
    x.copy_(torch.triu(x) + torch.triu(x, 1).mT)
    return out


def loocv_sym_reference(src, rows: torch.Tensor, scal: torch.Tensor, *,
                        return_stats: bool = False, **flags):
    """Plain-torch twin of the symmetric kernel: :func:`loocv_reference`,
    then :func:`mirror_x_block` (the statistics beside it unchanged)."""
    if return_stats:
        out, stats = loocv_reference(src, rows, scal, return_stats=True,
                                     **flags)
        return mirror_x_block(out), stats
    return mirror_x_block(loocv_reference(src, rows, scal, **flags))


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


_KERNELS = {torch.float64: "cvm_loocv_f64", torch.float32: "cvm_loocv_f32"}
_SYM_KERNEL = "cvm_loocv_sym_f64"


def _launch(name, src, rows, scal, out, stats, flags: int,
            resolution: float, extra=()) -> None:
    """Launch ``name`` of ``loocv.cu``; ``stats`` is ``None`` (no
    statistics stored) or the (F, 2, C) buffer that receives them;
    ``extra`` are trailing int arguments before the device (the folds per
    block)."""
    from . import _build

    fn = getattr(_build.load_library("loocv"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 12
                   + [ctypes.c_int64] * 3
                   + [ctypes.c_int, ctypes.c_double]
                   + [ctypes.c_int] * len(extra)
                   + [ctypes.c_int, ctypes.c_void_p])
    f_folds, k, c = out.shape
    m = c - k
    vec = torch.empty((f_folds, 5, c), dtype=out.dtype, device=out.device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = fn(_ptr(rows), _ptr(src.total), _ptr(src.xw), _ptr(src.xu),
             _ptr(src.yu), _ptr(src.yw), _ptr(src.gx), _ptr(src.gy),
             _ptr(scal), _ptr(vec), _ptr(stats), _ptr(out), f_folds, k, m,
             flags, float(resolution), *extra, out.device.index,
             ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def _dispatch(name, src, rows, scal, impl, out, flags, dtypes):
    """Check the operands of a LOOCV kernel; returns ``(rows, out, bits)``
    for a launch, or ``(rows, None, None)`` where the twin runs. Rows that
    are views of ``src.rows`` pass as they are; other rows are checked and
    moved to the sources' device."""
    if impl not in IMPLS:
        raise ValueError(f"Unknown impl: {impl!r} (auto|cuda|torch).")
    device = src.xw.device
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(
            f"impl='cuda' needs CUDA tensors; the sources are on {device}."
        )
    if shares_storage(rows, src.rows):
        rows = rows.reshape(-1)
    else:
        rows = to_device(check_rows(rows, src.xw.shape[0]), device)
    if impl == "torch" or (impl == "auto" and device.type == "cpu"):
        return rows, None, None
    if device.type != "cuda":
        raise ValueError(f"{name} has no kernel for device {device}.")
    dtype = src.xw.dtype
    if dtype not in dtypes:
        raise ValueError(f"{name} has no kernel for {dtype}.")

    f_folds, (k, c) = rows.shape[0], src.total.shape
    m = c - k
    if c > 1024:  # the single-tile gate; the kernel's shared memory
        raise ValueError(
            f"[X|Y] width {c} > 1024 leaves the LOOCV route; check "
            "loocv_single_tile_ok (the packed route takes such folds)."
        )
    operands = [src.total, src.xw, src.xu, src.gx, scal]
    if flags["with_y"]:
        operands += [src.yu, src.yw, src.gy]
    elif m:
        raise ValueError("with_y=False needs XTX-only sources (C == K).")
    for t in operands:
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name} operands must all be {dtype} on "
                             f"{device}.")
        if not t.is_contiguous():
            raise ValueError(f"{name} operands must be contiguous.")
    if scal.shape != (f_folds, 3):
        raise ValueError(f"scal must be ({f_folds}, 3), got {tuple(scal.shape)}")
    if out is None:
        out = torch.empty((f_folds, k, c), dtype=dtype, device=device)
    elif (out.shape != (f_folds, k, c) or out.dtype != dtype
          or out.device != device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {dtype} ({f_folds}, {k}, "
                         f"{c}) tensor on {device}.")
    bits = sum(b for n, b in _FLAG_BITS.items() if flags[n])
    return rows, out, bits


def fused_loocv(src, rows, scal: torch.Tensor, *, center_xtx: bool,
                center_xty: bool, scale_x: bool, scale_y: bool,
                with_y: bool, resolution: float, sym: bool = False,
                folds_per_block: int = 1, impl: str = "auto",
                out=None, return_stats: bool = False):
    """All-in-one LOOCV downdate of fold rows ``rows`` -> (F, K, C), or
    with ``return_stats`` ``(out, stats)``.

    ``src`` holds the dataset-wide operands (see
    :class:`cvmatrix_tpu_torch.core.batch.LoocvSources`); ``scal`` the
    (F, 3) per-fold scalars; every operand float64, or every operand
    float32. ``out``, when given, is a contiguous (F, K, C) buffer of that
    dtype that receives the result. ``folds_per_block`` 2 launches two
    folds per block (an odd F leaves the last block one fold); the result
    is the same, bit for bit. ``sym`` (float64 only, one fold per block)
    launches the symmetric kernel: the X block's upper triangle and every
    XTY column computed as here, the strictly lower triangle of the X
    block their mirror (exactly symmetric). ``return_stats``: the kernel
    also stores each fold's training statistics, (F, 2, C) in the sources'
    dtype: row 0 the means, row 1 the stds (clamped to 1 at or below
    ``resolution``), X in columns ``[0, K)`` and Y in ``[K, C)``; a mean is
    0 where neither centring nor scaling needs it and a std 1 on a side
    that is not scaled. Without it the kernel stores none, and the matrices
    are the same bit for bit. Launch counters: ``fused_loocv.launches``
    (float64), ``.launches_f32``, ``.launches_x2`` (float64, two per
    block), ``.launches_f32x2`` and ``.launches_sym``, one a launch;
    ``.launches_stats``, one a launch of any of them that stored the
    statistics.
    """
    if folds_per_block not in (1, 2) or (sym and folds_per_block != 1):
        raise ValueError(f"folds_per_block must be 1 or 2 (1 with sym), got "
                         f"{folds_per_block}")
    flags = dict(center_xtx=center_xtx, center_xty=center_xty,
                 scale_x=scale_x, scale_y=scale_y, with_y=with_y,
                 resolution=resolution)
    rows, res, bits = _dispatch(
        "fused_loocv", src, rows, scal, impl, out, flags,
        (torch.float64,) if sym else _KERNELS)
    if bits is None:
        twin = loocv_sym_reference if sym else loocv_reference
        got = twin(src, rows, scal, return_stats=return_stats, **flags)
        res, stats = got if return_stats else (got, None)
        if out is not None:
            res = out.copy_(res)
        return (res, stats) if return_stats else res
    f_folds, _, c = res.shape
    stats = (torch.empty((f_folds, 2, c), dtype=res.dtype, device=res.device)
             if return_stats else None)
    if sym:
        _launch(_SYM_KERNEL, src, rows, scal, res, stats, bits, resolution)
        name = "launches_sym"
    else:
        _launch(_KERNELS[res.dtype], src, rows, scal, res, stats, bits,
                resolution, (folds_per_block,))
        name = {(True, 1): "launches", (False, 1): "launches_f32",
                (True, 2): "launches_x2", (False, 2): "launches_f32x2"}[
                    (res.dtype == torch.float64, folds_per_block)]
    setattr(fused_loocv, name, getattr(fused_loocv, name) + 1)
    if return_stats:
        fused_loocv.launches_stats += 1
        return res, stats
    return res


# kernel -> the attribute of fused_loocv that counts its launches
_COUNTERS = {
    "fused_loocv": "launches",
    "fused_loocv_f32": "launches_f32",
    "fused_loocv_x2": "launches_x2",
    "fused_loocv_f32x2": "launches_f32x2",
    "fused_loocv_sym": "launches_sym",
    # launches of any of the five that stored the training statistics
    "fused_loocv_stats": "launches_stats",
}


def reset_launch_counts() -> None:
    for attr in _COUNTERS.values():
        setattr(fused_loocv, attr, 0)


def launch_counts() -> dict:
    """``{kernel: launches}`` of the five LOOCV kernels, and under
    ``fused_loocv_stats`` those of their launches that stored the
    training statistics."""
    return {name: getattr(fused_loocv, attr)
            for name, attr in _COUNTERS.items()}


reset_launch_counts()
