"""Kernels of the port: plain twins, CUDA wrappers and their build."""

from typing import Dict


def launch_counts() -> Dict[str, int]:
    """The kernels launched since the last :func:`reset_launch_counts`,
    with their launches, over every kernel module (``fold_downdate``,
    ``loocv``, ``pls`` and ``slice_rows``); a kernel not launched is left
    out."""
    from . import fold_downdate, loocv, pls, slice_rows

    return {name: n for mod in (fold_downdate, loocv, pls, slice_rows)
            for name, n in mod.launch_counts().items() if n}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    from . import fold_downdate, loocv, pls, slice_rows

    for mod in (fold_downdate, loocv, pls, slice_rows):
        mod.reset_launch_counts()
