"""In-process kernel-routing A/B with ``set_routing`` (the JAX package's
``examples/kernel_routing_ab.py``).

The engine routes every fold sweep by itself; the defaults are the
measured winners and there is nothing to configure in normal use. For
measurement work, :func:`cvmatrix_tpu_torch.set_routing` swaps a routing
decision mid-process; the port reads the policy at every call, so the next
sweep takes the new route. ``df64x2`` (two LOOCV folds per block) applies
to one-row folds only, so at these 200-row folds both runs take the same
kernel, and the parity assert holds the probes equal.

Run: ``python -m cvmatrix_tpu_torch.examples.kernel_routing_ab [--device
cpu]``; on the card, time both variants with a real workload.
"""

import time

import numpy as np
import torch

from cvmatrix_tpu_torch import CVConfig, fit, policy, set_routing
from cvmatrix_tpu_torch.models.sweep import materialize_sweep

from ._common import device_arg

N, K, M, P = 20_000, 64, 4, 100


def main(argv=None) -> None:
    device = device_arg(__doc__, argv)
    rng = np.random.default_rng(0)
    X = rng.random((N, K))
    Y = rng.random((N, M))
    w = rng.random(N)

    cfg = CVConfig(center_X=True, center_Y=True, scale_X=True, scale_Y=True,
                   ddof=1, dtype=np.float64)
    state = fit(cfg, X, Y, w, device=device)
    idx = np.arange(N).reshape(P, N // P)

    def timed_sweep(label):
        probe = float(materialize_sweep(cfg, state, idx))  # warm-up
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        probe = float(materialize_sweep(cfg, state, idx))
        print(f"{label:28s} {time.perf_counter() - t0:8.4f} s  "
              f"probe={probe:.6f}")
        return probe

    print("active policy:", policy())
    base = timed_sweep("default routing")

    set_routing(df64x2=True)  # two-folds-per-block df64 LOOCV kernel
    try:
        variant = timed_sweep("df64x2 two-folds-per-step")
    finally:
        set_routing(df64x2=False)  # restore
    if not abs(base - variant) <= 1e-9 * max(1.0, abs(base)):
        raise AssertionError("routing changed the numbers!")
    print("parity OK: both routes produce the same probe")


if __name__ == "__main__":
    main()
