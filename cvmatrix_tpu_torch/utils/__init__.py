"""Host-side helpers of the PyTorch port: profiling, the kernel build
directory and shipped kernel libraries.

Counterpart of :mod:`cvmatrix_tpu.utils`:

- :mod:`~cvmatrix_tpu_torch.utils.profiling`: ``trace``, ``device_fence``
  and ``Stopwatch``;
- :mod:`~cvmatrix_tpu_torch.utils.cache`: ``enable_persistent_cache``, which
  moves the kernel build directory;
- :mod:`~cvmatrix_tpu_torch.utils.aot`: ``export_kernels`` and
  ``load_kernels``, the port's counterpart of ``export_program`` and
  ``load_program``: its compiled artifacts are its kernel libraries.

Two JAX modules have no counterpart. ``tracing.py`` (``is_concrete``,
``ensure_x64``): torch runs eagerly, so no index is ever a tracer, and
float64 is native, so there is no 64-bit mode to switch on. ``fnkey.py``:
it keys compiled-program caches on user callbacks, and the port caches no
programs.
"""

from .aot import export_kernels, load_kernels
from .cache import enable_persistent_cache
from .profiling import Stopwatch, device_fence, trace

__all__ = [
    "Stopwatch",
    "device_fence",
    "enable_persistent_cache",
    "export_kernels",
    "load_kernels",
    "trace",
]
