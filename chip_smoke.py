#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cvmatrix_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``)::

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. Device: require CUDA; print the card, its power limit and the toolchain.
2. Build: compile the kernels of ``cvmatrix_tpu_torch/csrc/`` (``loocv.cu``,
   ``fold_downdate.cu``, ``fold_epilogue.cu``, ``slice_rows.cu``,
   ``pls.cu``), one ``nvcc`` each, all at once; print their register and
   spill lines.
3. LOOCV kernel against its plain twin on the card: 16 flag sets x
   weighted and unweighted at N=2,000, K=500, M=10 over 64 folds, and the
   main path's first and last 256 folds; bound max|kernel - twin| <= 1e-12
   max|twin|. Times one 971-fold chunk through the kernel and the twin.
4. LOOCV main path: weighted, all four centre/scale flags on, float64,
   N=100,000, K=500, M=10, seed 42, leave-one-out over all 100,000 folds
   through ``materialize_cv``, once to warm up and once timed, with the
   kernel's launch count read around the timed run. Also times the fit
   alone and the fold sweep alone, through the kernel and the plain twin.
5. LOOCV oracle: the main path's probe and two folds' full matrices
   against the NumPy oracle ``tests/oracle.py``.
6. K-fold kernels against their twins: 16 flag sets x weighted and
   unweighted, [XTX | XTY] and XTX alone (XTY alone for two flag sets),
   at N=2,000, K=500, M=10, through ``training_matrices_batched`` for one
   fold batch per route (L=4 packed, L=100 v3, L=1,000 Ozaki-df64,
   L=1,025 epilogue), each also masked; every call must launch its route's
   kernel; bound 1e-12 max|twin|. Then the tensor-core tile's edges
   through ``fold_ozaki_df64``, ``fold_v3`` and ``fold_v3(sym=True)``:
   L = 1, 3, 10, 17, 100 and 1,003, K=37 with M=0, XTY alone (no v3), one
   fold, masked and unmasked, for TTTT and FFFF, weighted and not, at the
   same bound, one launch each; the symmetric X blocks exactly symmetric
   and their upper entries the full tile's bit for bit. Then the row-stream
   tile (``fold_packed`` and ``fold_smallfold``) at its edges: L = 1, 2, 3,
   4, 9, 17 and 31; [XTX | XTY] at K=37, M=3 and K=500, M=10, XTX alone
   at K=37, XTY alone (packed); one fold and 67; masked and not; operands
   and out as fold-offset views of a larger batch and not; one launch a
   call, a second call bit-equal, at the same bound.
   Then the first full-width chunk of each phase 7 sweep (P=25,000,
   10,000, 1,000, 100, 10 and the masked P=3 at N=100,000) through the
   kernel and through the twin, held at the same bound, and each route's
   chunk timed through both, the product chunks with their TFLOP/s and
   ``torch.bmm`` of the same gathered blocks in the same run, the
   epilogue in turns with a same-traffic ceiling (``prod.sub_(total)``,
   one in-place PyTorch call over the same bytes); the packed
   chunk, bound by its stores, in turns with ``torch.bmm`` of its u, v
   streams and a pure write of its output bytes (``fill_``), the store
   rate the card reaches, logged as a ceiling beside the 3.35 TB/s bound.
7. K-fold path at full width: the configuration of phase 4 through
   ``materialize_cv`` over ``Partitioner(np.arange(N) % P)`` for P =
   25,000, 10,000, 1,000, 100, 10 and 3 (the last masked), once to warm
   up and once timed, the launch counts read around the timed run (the
   route's kernel once per chunk, no other), then the sweep alone through
   the kernels and through the plain twins.
8. K-fold oracle: each P's probe and its probe fold's full matrices
   against ``tests/oracle.py`` at 1e-10.
9. Float32 kernels against their twins: 16 flag sets x weighted and
   unweighted x [XTX | XTY], XTX alone and XTY alone at N=2,000, K=500,
   M=10, through ``training_matrices_batched``: L=1 (LOOCV, or packed for
   XTY alone), L=4 and masked L=1 (packed f32), L=100 and masked L=1,025
   (``fused_downdate``); every call must launch its route's kernel and no
   other; bound 1e-4 max|twin| (sums in float32 in another order);
   ``fused_downdate``'s kernel and twin each also read against the
   float64 engine on the same data. Then
   the float32 stream tile of ``fold_downdate_f32`` on seeded streams:
   F=1, 2 and 3 at L=33,334 and F=2 at L=1,025 (split across blocks),
   L=32 and 100 (unsplit), K=37 with C=43 and K=48 with C=52, unmasked
   and masked, at the same bound, one launch a call, a second call
   bit-equal; the kernel and the twin each also read against the same
   formula in float64. Then the row-stream tile's edges of phase 6 in
   float32 at 1e-4.
10. Float32 LOOCV main path: phase 4's configuration and data cast to
    float32, all 100,000 folds through ``materialize_cv``, warm-up and
    timed, one ``fused_loocv_f32`` launch per chunk and no other kernel;
    the first chunk against its twin and timed through both; the probe and
    two folds against ``tests/oracle.py`` at 1e-3 max|oracle|.
11. Float32 K-fold at full width: the same data over P = 25,000 (L=4,
    packed f32), 1,000 (L=100) and 3 (L=33,334, masked; both
    ``fused_downdate``): warm-up and timed totals with the launch counts,
    each P's first chunk against its twin and timed through both, with
    its split count, TFLOP/s, bound and ``torch.bmm`` of its blocks (the
    packed chunk in turns with ``torch.bmm`` of its streams and a pure
    write, as in phase 6), each probe fold against the oracle at 1e-3
    max|oracle|.
12. TF32: the float32 fit under ``torch.set_float32_matmul_precision(
    "high")`` is bit for bit the fit under "highest" (a bare float32
    product under "high" is not).
13. The routing policy's kernels against their twins: the two-folds-per-
    block LOOCV kernels (float64 and float32) over 64 and 63 folds, the
    symmetric LOOCV kernel, and the symmetric v3 kernel at L=100 unmasked
    and masked, for 16 flag sets x weighted and unweighted at N=2,000,
    K=500, M=10; float64 at 1e-12 and float32 at 1e-4 of the twin's
    largest entry, the x2 kernels equal to one fold per block bit for
    bit, the symmetric X blocks exactly symmetric; every call launches
    its kernel and no other. Then each one's full-width chunk against its
    twin, timed in turns beside the kernel it varies (one fold per block,
    or the full kernel); the symmetric v3 chunks at P=1,000 and 10,000
    also beside ``torch.bmm`` of the gathered blocks.
14. The policy-routed main paths at full width: phase 4's configuration
    through ``materialize_cv`` under ``set_routing`` (sym LOOCV, sym at
    P=10,000 and P=1,000, df64x2 LOOCV, f32x2 float32 LOOCV, and sym with
    df64x2, where sym wins), warm-up and timed, every launch count reset
    just before the timed run: one launch per chunk of the expected kernel
    and no other; each probe against ``tests/oracle.py``.
15. Reduce sweeps at full width: fit plus ``cross_validate_reduce`` over
    LOOCV with a trace (default policy and ``sym_loocv``), P=25,000 (the
    packed loop) with a trace, P=1,000 (the v3 loop) with a ridge solve,
    and P=1,000 under ``hoist_reduce=False``, timed beside the
    ``materialize_cv`` total of the same P, the launch counts checked
    (the LOOCV kernel storing the statistics once a chunk), and three
    folds' reductions against the per-fold engine.
16. Small-fold LOOCV sources: the port of ``fused_smallfold_df64`` against
    its twin at N=2,000, K=500, M=10 for 16 flag sets x weighted and
    unweighted x [XTX | XTY] and XTX alone, 16 folds of L=4 unmasked and
    masked (padded slots at index 0), float64 at 1e-12 and float32 at 1e-4
    of the twin's largest entry, one launch of the dtype's kernel each.
    Then at full width on phase 4's data: the first 962-fold chunk of
    P=25,000 through the kernel (``smallfold_from_sources`` on the rows the
    sources checked, so no sync), its twin and the packed kernel, all three
    within 1e-12, timed in turns with ``torch.bmm`` of the gathered blocks
    and a pure write of the output, as in phase 6, and the same chunk
    through the float32 instance on phase 10's data; for each, the vector
    phase's share of the device time under ``torch.profiler``; fit +
    ``prepare_loocv_sources`` + ``smallfold_from_sources`` over all folds
    of P=25,000 (L=4) and of the masked P=30,000 (10,000 folds of 4 rows,
    20,000 of 3) in ``materialize_cv``'s chunks, warm-up and timed beside the
    ``materialize_cv`` total, one launch a chunk and no other kernel; each
    probe fold against ``tests/oracle.py`` at 1e-10.
17. The mantissa slicer at full width: phase 4's X as float32 hi/lo planes
    (100,000 x 500), ``pows`` from each column's largest magnitude,
    ``block_rows=32``, 10 slices, both layouts: the kernel bit-equal to its
    twin, slices within 65, the reconstruction within 2^-58 of the scaled
    pair, one launch each, timed in turns with the twin (row-major also at
    one slice, whose difference is the cost of the rounds, and beside a
    ``copy_`` of the 0.9 GB the slicer moves, a ceiling).
18. The wide-K path at full width (BASELINE.json config 4): weighted, all
    four flags on, float64, N=5,000, K=20,000, M=1, data from seed 42 as
    ``bench.py`` builds it, ``materialize_cv`` over
    ``Partitioner(np.arange(N) % 10)`` (ten chunks of one fold of 500 rows,
    each a ``torch.bmm`` and the epilogue), warm-up and timed, with the
    launch counts read around the timed run (ten ``fold_epilogue``
    launches, no other kernel), the builds of ``[XTX | XTY]`` counted (one
    a sweep) and the peak device memory; the fit alone and the sweep
    alone; the first chunk's product timed (TFLOP/s) and its epilogue held
    against the twin at 1e-12 and timed as in phase 6; the probe and the
    probe fold's entries on the first and last 128 columns of X and on Y
    against ``tests/oracle.py`` fitted on those columns, at 1e-10.
19. The mesh layer (``cvmatrix_tpu_torch.parallel``). (a) World size 1 on
    NCCL (an in-process store, no port): ``fit_sharded`` and, at full
    width (phase 4's data), ``sharded_cross_validate_reduce`` with
    ``diag_fn`` at LOOCV (the natural-order path), P=25,000 (small-fold
    hoisted), P=1,000 (v3 hoisted), P=100 (generic, Ozaki-df64) and P=10
    (generic, ``torch.bmm`` and the epilogue), in float32 at LOOCV,
    P=25,000 and P=1,000 (``fused_downdate``), and
    ``sharded_training_matrices`` at P=1,000; then on the first 20,000
    rows the cases of the two-rank check and the policy rows (df64x2,
    sym_loocv and f32x2 LOOCV, sym_loocv at P=200). Every run with the
    launch counts at 0 just before it: its one kernel launched and no
    other; its result against the single-device port at 1e-10 of the
    largest entry (float32 1e-4) and one fold against ``tests/oracle.py``.
    Times, host clock after a warm-up: the sharded reduce beside
    ``cross_validate_reduce`` at LOOCV and P=25,000, ``fit_sharded``
    beside ``fit``, and the collectives at world size 1. (b) Two ranks on
    the one card over gloo (this script with ``--mesh-rank``, two
    processes, the collectives through host copies) on the first 20,000
    rows, held against (a)'s one-rank results. Every kernel the mesh path
    reaches must have launched.
20. The reference grid at full width (``cvmatrix_tpu_torch.benchmarks.
    grid.run_row``, the counterpart of ``benchmarks/benchmark.py``) on
    phase 4's data: the three plot flag sets, weighted and unweighted, at
    P = 3, 5, 10, 100, 1,000, 10,000 and 100,000 in float64 (42 rows), all
    four flags at the same Ps in float32 (14 rows), ``nojit`` and
    ``coldjit`` for weighted TTTT at P = 1,000 and 100, and one ``aotcold``
    row (the libraries exported and loaded through ``utils.aot``). Each
    row's launch counts, read around its timed total: the route's kernel
    once a chunk and no other (none in ``nojit``); its probe against the
    per-fold engine in plain torch on the same folds (float64 1e-10
    relative, float32 1e-3 of the largest entry); at P = 100,000 and 3 the
    probe fold's full matrices against ``tests/oracle.py`` (1e-10; float32
    1e-3 of the oracle's largest entry). The rows go to
    ``chiprun_out/grid_h100.csv`` in the JAX grid's schema.
21. The scripts and examples on the card, each in its own process:
    ``benchmarks/widek_genomics`` at full size (BASELINE.json config 4
    through ``cross_validate_reduce``: total, folds/s, peak memory, its
    spot check and ten epilogue launches), ``benchmarks/mesh_one_chip`` at
    P = 100,000 and 1,000, and the six examples, the mesh one under
    ``torch.distributed.run``; each must exit 0.
22. The bench entry, ``bench_torch.py``, each run in its own process on
    the card at full width: the default (P=N, float64), float32 LOOCV,
    P=25,000, 10,000, 1,000, 100, 10 and 3, wide K (N=5,000, K=20,000,
    M=1, P=10) and LOOCV under ``CVMATRIX_TPU_SYM_LOOCV=1``; the default
    and P=1,000 three times each, in turns, for their spread (min, median,
    max). Each run: exit code 0, one stdout line under ``bench.py``'s
    metric name with the package and the card, the launches of its timed
    total exactly its route's kernel once a chunk, its probe within 1e-12
    relative (float32 1e-5) of the probe of the earlier phase that ran the
    same configuration on the same data (phases 4, 7, 10, 14, 18 and 20),
    whose total it logs beside its own.
23. PLS cross-validation (``models.pls``, the port's own kernels) at full
    width on phase 4's data: A=20 components, leave-one-out in chunks of
    511 folds (196). The first and last chunks through the operator kernel
    ``ikpls2_op`` and its twin, and through the kernel on formed matrices
    ``ikpls2`` (the reduce sweep's chunks, as its consumer gets them) and
    its twin: each kernel against its twin and the two kernels against
    each other, every fold's PRESS within 1e-12 of its largest; one chunk
    timed in turns (operator twin, formed, operator, operator, formed,
    operator twin, formed twin), and the clusters of ``ikpls2_op`` the card
    holds at once. Then ``cross_validate_pls`` over every fold: one
    ``ikpls2_op`` launch a chunk and no other kernel, F x A fold-components
    a chunk all on the operator route, the two chunks' folds within 1e-12
    of the kernel's own, and folds 0 and N-1 within 1e-9 of
    ``tests/pls_reference.py`` on the card.
24. Wide-K PLS cross-validation at the shape of the cell
    ``ikpls_widek_n5k.kfold10`` (phase 18's data: N=5,000, K=20,000, M=1,
    P=10 in chunks of 2, A=20, weighted, every flag on, ddof 1). The first
    chunk's formed matrices, as the reduce sweep's consumer gets them,
    through ``models.pls.solve`` (``ikpls2`` sends K over ``MAX_K`` to
    ``ikpls2_wide``): 2 A + 2 ``ikpls2_wide`` launches a solve and no other
    kernel, the same bits twice, within 1e-10 of the twin's PRESS (of each
    fold's largest); timed in turns with the twin. The same chunk with no
    fold matrix formed, through ``models.pls.solve_wide_operator``: 3 A + 2
    ``ikpls2_wide_op`` launches a solve and no other kernel, the same bits
    twice, within 1e-12 of its twin; timed in turns with the formed
    route's solve and the twin. Then ``cross_validate_pls`` over every
    fold: 3 A + 2 ``ikpls2_wide_op`` launches a chunk and no other kernel,
    P x A fold-components all on the wide operator route, the first chunk
    within 1e-12 of the kernels' own, and folds 0 and P-1 within 1e-9 of
    ``tests/pls_reference.py`` on the card.
25. Soil-spectra PLS2 at the shape of the cell ``lucas_n20k.kfold10``
    (N=20,000, K=4,200, M=12, P=10 interleaved folds of 2,000 rows, A=20,
    weighted, every flag on, ddof 1; seeded uniform data): the one chunk
    of 10 folds through ``models.pls.solve_wide_operator``, 3 A + 2
    ``ikpls2_wide_op`` launches a solve and no other kernel, the same bits
    twice, within 1e-12 of its twin; timed in turns with the formed
    route's ``models.pls.solve`` (``ikpls2``) of the same chunk. Then
    ``cross_validate_pls`` over every fold: 3 A + 2 ``ikpls2_wide_op``
    launches and no other kernel, P x A fold-components all on the wide
    operator route, one ``models.pls.route.wide_op`` span, the chunk's
    PRESS bit-equal to the kernels' own, and folds 0 and 9 within 1e-9 of
    ``tests/pls_reference.py`` on the card.
26. Prints the kernels' JSON line (eighteen kernels, each with its bound and
    the library call's time where one PyTorch call computes the same
    function, the epilogue again as ``fold_epilogue_widek`` on the wide-K
    path, each one's ``mesh_launches`` in phase 19 (a),
    ``grid_launches`` in phase 20 and ``bench_launches`` in phase 22), the
    card's name and power limit, and as the last line
    ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import importlib.util
import itertools
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N, K, M, SEED = 100_000, 500, 10, 42
KC = dict(k=K, c=K + M)  # the main path's (K, C), for the cost functions
# The wide-K path (BASELINE.json config 4, benchmarks/widek_genomics.json
# "default"): N, K, M, P.
WIDEK = (5_000, 20_000, 1, 10)
TWIN_RTOL = 1e-12
ORACLE_RTOL = 1e-10
# Phase 23: PLS components, the sweep's batch_size, and the PRESS of folds
# 0 and N-1 against tests/pls_reference.py, relative to the fold's largest
# PRESS: the cell ikpls_n100k.loocv read at most 1.56e-11 over 21 seeds of
# its data, against the same reference.
PLS_A = 20
PLS_BATCH = 512
PLS_ORACLE_RTOL = 1e-9
# Phase 24: the wide route's chunk of folds at the cell
# ikpls_widek_n5k.kfold10 (WIDEK, 5 chunks of 2), and its kernels against
# the twin on one formed chunk, relative to each fold's largest PRESS (the
# bound of the card tests, tests/test_torch_pls.py).
PLS_WIDE_BATCH = 2
PLS_WIDE_TWIN_RTOL = 1e-10
# Phase 25: the cell lucas_n20k.kfold10 (the LUCAS topsoil vis-NIR
# library's size): N, K, M, P; its 10 folds are one chunk at
# cross_validate_pls's default batch_size (PLS_BATCH).
LUCAS = (20_000, 4_200, 12, 10)
# P -> the wrapper whose kernel the K-fold main path must launch
KFOLD_P = ((25_000, "fold_packed"), (10_000, "fold_v3"), (1_000, "fold_v3"),
           (100, "fold_ozaki_df64"), (10, "fold_epilogue"),
           (3, "fold_epilogue"))
# Fold sizes at which phase 6 holds the tensor-core tile against its twins,
# and phases 6 and 9 the row-stream tile (the packed and small-fold routes).
TILE_EDGE_L = (1, 3, 10, 17, 100, 1003)
ROW_EDGE_L = (1, 2, 3, 4, 9, 17, 31)
ROUTE_WRAPPER = {"packed": "fold_packed", "v3": "fold_v3",
                 "ozaki_df64": "fold_ozaki_df64", "epilogue": "fold_epilogue"}
KERNEL_SOURCES = {
    "fused_loocv": ("cvmatrix_tpu_torch/csrc/loocv.cu",
                    "cvmatrix_tpu/ops/kernels.py:892"),
    "fold_packed": ("cvmatrix_tpu_torch/csrc/fold_downdate.cu",
                    "cvmatrix_tpu/ops/kernels.py:382"),
    "fold_v3": ("cvmatrix_tpu_torch/csrc/fold_downdate.cu",
                "cvmatrix_tpu/ops/kernels.py:2333"),
    "fold_ozaki_df64": ("cvmatrix_tpu_torch/csrc/fold_downdate.cu",
                        "cvmatrix_tpu/ops/kernels.py:1385"),
    "fold_epilogue": ("cvmatrix_tpu_torch/csrc/fold_epilogue.cu",
                      "cvmatrix_tpu/ops/kernels.py:531"),
    "fused_loocv_f32": ("cvmatrix_tpu_torch/csrc/loocv.cu",
                        "cvmatrix_tpu/ops/kernels.py:1826"),
    "fold_packed_f32": ("cvmatrix_tpu_torch/csrc/fold_downdate.cu",
                        "cvmatrix_tpu/ops/kernels.py:630"),
    "fold_downdate_f32": ("cvmatrix_tpu_torch/csrc/fold_downdate.cu",
                          "cvmatrix_tpu/ops/kernels.py:105"),
    "fused_loocv_x2": ("cvmatrix_tpu_torch/csrc/loocv.cu",
                       "cvmatrix_tpu/ops/kernels.py:1003"),
    "fused_loocv_f32x2": ("cvmatrix_tpu_torch/csrc/loocv.cu",
                          "cvmatrix_tpu/ops/kernels.py:1980"),
    "fused_loocv_sym": ("cvmatrix_tpu_torch/csrc/loocv.cu",
                        "cvmatrix_tpu/ops/kernels.py:1190"),
    "fold_v3_sym": ("cvmatrix_tpu_torch/csrc/fold_downdate.cu",
                    "cvmatrix_tpu/ops/kernels.py:2430"),
    "fold_smallfold": ("cvmatrix_tpu_torch/csrc/fold_downdate.cu",
                       "cvmatrix_tpu/ops/kernels.py:1631"),
    "slice_rows": ("cvmatrix_tpu_torch/csrc/slice_rows.cu",
                   "cvmatrix_tpu/ops/kernels.py:2642"),
    # the epilogue again, on phase 18's wide-K path
    "fold_epilogue_widek": ("cvmatrix_tpu_torch/csrc/fold_epilogue.cu",
                            "cvmatrix_tpu/ops/kernels.py:531"),
    # the port's own: no TPU kernel stands behind it
    "ikpls2": ("cvmatrix_tpu_torch/csrc/pls.cu", None),
    "ikpls2_op": ("cvmatrix_tpu_torch/csrc/pls.cu", None),
    "ikpls2_wide": ("cvmatrix_tpu_torch/csrc/pls.cu", None),
    "ikpls2_wide_op": ("cvmatrix_tpu_torch/csrc/pls.cu", None),
}
# Float32: kernel against twin at the JAX package's f32 interpret bound, and
# against the float64 oracle at its "f32 grade", of the largest entry.
F32_TWIN_RTOL = 1e-4
F32_ORACLE_RTOL = 1e-3
ROUTE_WRAPPER_F32 = {"loocv": "fused_loocv_f32",
                     "packed_f32": "fold_packed_f32",
                     "downdate_f32": "fold_downdate_f32"}
KFOLD_P32 = ((25_000, "fold_packed_f32"), (1_000, "fold_downdate_f32"),
             (3, "fold_downdate_f32"))
# The policy-routed full-width sweeps: (label, set_routing knobs, dtype, P,
# the kernel each chunk must launch).
POLICY_RUNS = (
    ("sym_loocv LOOCV", dict(sym_loocv=True), np.float64, N,
     "fused_loocv_sym"),
    ("sym_loocv P=10,000", dict(sym_loocv=True), np.float64, 10_000,
     "fold_v3_sym"),
    ("sym_loocv P=1,000", dict(sym_loocv=True), np.float64, 1_000,
     "fold_v3_sym"),
    ("df64x2 LOOCV", dict(df64x2=True), np.float64, N, "fused_loocv_x2"),
    ("f32x2 float32 LOOCV", dict(f32x2=True), np.float32, N,
     "fused_loocv_f32x2"),
    ("sym_loocv + df64x2 LOOCV", dict(sym_loocv=True, df64x2=True),
     np.float64, N, "fused_loocv_sym"),
)
# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s, and
# FLOP/s of FP64 on the tensor cores and of FP32 outside them (both 67 T).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 67e12


def bound(nbytes: float, flops: float):
    """``(ms, "bytes" | "operations")``: the least time the card could take
    to move ``nbytes`` (each input read once, each output written once) and
    to do ``flops``, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fold_cost(f: int, n_l: int, item: int, *, k: int, c: int,
              sym: bool = False, gathered: bool = True):
    """Bytes and FLOPs of F folds of L rows each at (K, C) = (k, c), C = K
    + M: the (F, K, C) output written once, the total and the global sums
    read once, and each fold row once as C values and its weight (the
    kernels' weighted and unweighted copies of a row, and the per-fold
    vectors, derive from these), plus its int64 index where the kernel
    gathers rows; the product (2L FLOPs) and a four-FLOP epilogue per
    computed entry (the symmetric kernels compute the upper triangle and
    the XTY columns)."""
    nbytes = (item * (f * k * c + k * c + 2 * c + f * n_l * (c + 1))
              + (8 * f * n_l if gathered else 0))
    computed = f * (k * (k + 1) // 2 + k * (c - k)) if sym else f * k * c
    return nbytes, (2 * n_l + 4) * computed


def epilogue_cost(f: int, *, k: int, c: int):
    """The in-place epilogue of F folds at (K, C) = (k, c): the product
    read and rewritten, the total and the vectors; four FLOPs per entry."""
    return 8 * (2 * f * k * c + k * c + 2 * f * (k + c)), 4 * f * k * c


def log(*a) -> None:
    print(*a, flush=True)


def dtype_name(itemsize: int) -> str:
    return "float64" if itemsize == 8 else "float32"


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` between CUDA events (warm). The
    device first spins for about 10 ms while the host queues the calls, so
    host time between short launches is not counted (as on the main path,
    where the host runs ahead of each chunk's product)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall(fn):
    """(seconds, result) of ``fn`` between two device synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, res


def press_rel(got, ref):
    """Widest gap of each fold's PRESS over its largest, worst fold."""
    scale = ref.abs().amax(dim=(1, 2), keepdim=True)
    return float(((got - ref).abs() / scale).max())


def lucas_phase(dev, card: str) -> dict:
    """Phase 25: the soil-spectra cell's one chunk through the wide
    operator below ``MAX_K`` at M = 12, against its twin, timed in turns
    with the formed route's ``ikpls2``, then ``cross_validate_pls`` over
    every fold against the reference. Returns the phase's numbers."""
    from cvmatrix_tpu_torch import CVConfig, cross_validate_pls, fit
    from cvmatrix_tpu_torch.models import pls as TP
    from cvmatrix_tpu_torch.models.sweep import cross_validate_reduce
    from cvmatrix_tpu_torch.ops import fold_downdate as FD
    from cvmatrix_tpu_torch.ops import loocv as TL
    from cvmatrix_tpu_torch.ops import pls as OP
    from cvmatrix_tpu_torch.ops import slice_rows as SR
    from cvmatrix_tpu_torch.utils import profiling as P
    from cvbench.pls_costs import pls_cost
    from tests.pls_reference import fold_press

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    n, k, m, p = LUCAS
    flags = dict(center_X=True, center_Y=True, scale_X=True, scale_Y=True)
    cfg = CVConfig(*flags.values(), ddof=1, dtype=np.float64)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    X, Y, w = (torch.rand(shape, generator=g, dtype=torch.float64,
                          device=dev) for shape in ((n, k), (n, m), (n,)))
    st = fit(cfg, X, Y, w, copy=False)
    idx = np.arange(n).reshape(-1, p).T.copy()  # fold q: rows q, q + P, ..
    n_l = idx.shape[1]
    rows = torch.as_tensor(idx, device=dev)
    per_op = 3 * PLS_A + 2

    def wide_op_solve(impl):
        """The chunk through ``solve_wide_operator`` (under "torch" the
        twin, called directly)."""
        if impl == "torch":
            sums = (st.sum_X, st.sum_sq_X, st.sum_Y, st.sum_sq_Y, st.sum_w,
                    st.num_nonzero_w)
            return OP.ikpls2_wide_op_reference(
                st.XTX, st.XTY, st.X, st.Y, st.weights, sums, rows, None,
                n_components=PLS_A, ddof=1, resolution=cfg.resolution,
                **flags)
        return TP.solve_wide_operator(cfg, st, rows, None,
                                      n_components=PLS_A, impl=impl)

    reset_launch_counts(TL, FD, SR, OP)
    op, again = wide_op_solve("cuda"), wide_op_solve("cuda")
    torch.cuda.synchronize()
    got = launch_counts(TL, FD, SR, OP)
    twin = wide_op_solve("torch")
    torch.cuda.synchronize()
    if {k_: v for k_, v in got.items() if v} != {"ikpls2_wide_op": 2 * per_op}:
        raise AssertionError(f"two wide operator solves at M={m} launched "
                             f"{got}, expected {2 * per_op}")
    rel = press_rel(op, twin)
    if not (bool(torch.isfinite(op).all()) and torch.equal(op, again)
            and rel <= TWIN_RTOL):
        raise AssertionError(f"ikpls2_wide_op vs twin at K={k}, M={m}: "
                             f"relative {rel} > {TWIN_RTOL:g}, or not "
                             "finite, or not the same bits twice")
    del twin, again

    held = []
    cross_validate_reduce(cfg, st, idx, batch_size=PLS_BATCH,
                          chunk_fn=lambda mats, stats, r: held.append(
                              (mats, stats, r)) or r.X.new_zeros(
                                  r.X.shape[0]))
    (mats, stats, vrows), = held
    del held

    def formed_solve():
        """The same chunk on its formed fold matrices: ``ikpls2``."""
        return TP.solve(cfg, mats, stats, vrows, n_components=PLS_A,
                        impl="cuda")

    formed_rel = press_rel(op, formed_solve()[:p])
    ms = {"wide_op": [], "formed": []}
    for what in ("wide_op", "formed", "wide_op", "formed"):
        fn = ((lambda: wide_op_solve("cuda")) if what == "wide_op"
              else formed_solve)
        ms[what].append(cuda_ms(fn, 3))
    del mats, stats, vrows
    least = bound(*pls_cost([(p, n_l)], k, m, PLS_A, 8, True))
    moved = PLS_A * (k * (k + 1) / 2 + 2 * n * k) * 8
    best = min(ms["wide_op"])
    log(f"[pls-lucas] one chunk of {p} folds (L={n_l:,}, K={k:,}, M={m}, "
        f"A={PLS_A}): wide operator {ms['wide_op']} ms, formed route's "
        f"ikpls2 {ms['formed']} ms (in turns); {per_op} launches a solve, "
        f"all ikpls2_wide_op; against the twin relative {rel:.3e}, against "
        f"ikpls2 {formed_rel:.3e}; bound {least[0]:.4f} ms by {least[1]}; "
        f"the triangle and the rows twice a component {moved / 1e9:.2f} GB, "
        f"{moved / best / 1e6:.0f} GB/s  [{card}]")

    torch.cuda.empty_cache()
    reset_launch_counts(TL, FD, SR, OP)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t_cv, press = wall(lambda: cross_validate_pls(
            cfg, st, idx, n_components=PLS_A))
    spans = [e.name for e in prof.events() if e.name.startswith(P.PLS_ROUTE)]
    got = launch_counts(TL, FD, SR, OP)
    if {k_: v for k_, v in got.items() if v} != {"ikpls2_wide_op": per_op}:
        raise AssertionError(f"cross_validate_pls launched {got}, expected "
                             f"{per_op} ikpls2_wide_op and no other kernel")
    comps = {r: OP.fold_components(r) for r in ("wide_op", "wide",
                                                "matrices", "operator")}
    if comps != {"wide_op": p * PLS_A, "wide": 0, "matrices": 0,
                 "operator": 0}:
        raise AssertionError(f"fold-components {comps}, expected "
                             f"{p * PLS_A}, all on the wide operator route")
    if spans != [P.PLS_ROUTE + "wide_op"]:
        raise AssertionError(f"route spans {spans}, expected one wide_op")
    if not torch.equal(press, op):
        raise AssertionError("cross_validate_pls vs the kernels on its one "
                             f"chunk: {press_rel(press, op)}")
    oracle = {}
    for q in (0, p - 1):
        ref = fold_press(X, Y, w, idx[q], n_components=PLS_A, ddof=1,
                         **flags)
        oracle[q] = press_rel(press[q:q + 1], ref[None])
    torch.cuda.synchronize()
    if not max(oracle.values()) <= PLS_ORACLE_RTOL:
        raise AssertionError(f"soil-spectra cross_validate_pls vs "
                             f"tests/pls_reference.py: {oracle} > "
                             f"{PLS_ORACLE_RTOL:g}")
    log(f"[pls-lucas] cross_validate_pls, N={n:,}, K={k:,}, M={m}, {p} "
        f"folds in one chunk, A={PLS_A}: {t_cv:.4f} s ({p / t_cv:.1f} "
        f"folds/s); launches {got}; fold-components {comps}; spans {spans}; "
        f"folds 0 and {p - 1} against the reference {oracle}; phase 25 in "
        f"{time.perf_counter() - t_phase:.1f} s  [{card}]")
    return {"wide_op_ms": ms["wide_op"], "formed_ms": ms["formed"],
            "twin_rel": rel, "formed_rel": formed_rel, "oracle": oracle,
            "cross_validate_s": t_cv}


# The LOOCV kernels' launches that stored the training statistics: a
# count of launches already counted under their kernel's name.
STATS_COUNTER = "fused_loocv_stats"


def launch_counts(*mods) -> dict:
    """Every kernel's launch count in the wrapper modules ``mods``, by the
    kernels line's names (not ``STATS_COUNTER``, which is no kernel)."""
    return {name: n for mod in mods for name, n in mod.launch_counts().items()
            if name != STATS_COUNTER}


def reset_launch_counts(*mods) -> None:
    for mod in mods:
        mod.reset_launch_counts()


# The reference grid (phase 20, ``cvmatrix_tpu_torch.benchmarks.grid``):
# (dtype, flags, weighted, P, mode) of each row: the float64 plot configs
# weighted and unweighted, the float32 TTTT rows, then nojit, coldjit and
# aotcold rows; and the kernels its rows must launch.
GRID_PS = (3, 5, 10, 100, 1_000, 10_000, N)
GRID_ROWS = (
    [(np.float64, flags, use_w, p, "warmjit") for use_w in (True, False)
     for flags in ((False,) * 4, (True, True, False, False), (True,) * 4)
     for p in GRID_PS]
    + [(np.float32, (True,) * 4, use_w, p, "warmjit")
       for use_w in (True, False) for p in GRID_PS]
    + [(np.float64, (True,) * 4, True, p, mode)
       for mode in ("nojit", "coldjit") for p in (1_000, 100)]
    + [(np.float64, (True,) * 4, True, 1_000, "aotcold")])
GRID_KERNELS = ("fused_loocv", "fold_epilogue", "fold_packed_f32",
                "fold_downdate_f32", "fold_ozaki_df64", "fused_loocv_f32",
                "fold_v3")
# The examples phase 21 runs, each in its own process (the mesh example
# under torch.distributed.run).
EXAMPLES = ("training_matrices", "training_matrices_batched",
            "cross_validation_reduce", "total_cv_fused", "kernel_routing_ab")
ROOT = os.path.dirname(os.path.abspath(__file__))
# The bench entry (phase 22): (label, dtype, (N, K, M, P), set_routing
# knobs, the kernel its timed total must launch and no other). The first
# two run three times each, in turns, for their spread.
BENCH_RUNS = (
    ("default", np.float64, (N, K, M, N), {}, "fused_loocv"),
    ("P=1,000", np.float64, (N, K, M, 1_000), {}, "fold_v3"),
    ("float32", np.float32, (N, K, M, N), {}, "fused_loocv_f32"),
    ("P=25,000", np.float64, (N, K, M, 25_000), {}, "fold_packed"),
    ("P=10,000", np.float64, (N, K, M, 10_000), {}, "fold_v3"),
    ("P=100", np.float64, (N, K, M, 100), {}, "fold_ozaki_df64"),
    ("P=10", np.float64, (N, K, M, 10), {}, "fold_epilogue"),
    ("P=3", np.float64, (N, K, M, 3), {}, "fold_epilogue"),
    ("wide K", np.float64, WIDEK, {}, "fold_epilogue"),
    ("sym_loocv", np.float64, (N, K, M, N), dict(sym_loocv=True),
     "fused_loocv_sym"),
)
BENCH_SPREAD = 3
# the entry's probe against the same sweep's in an earlier phase, relative
BENCH_RTOL = {np.float64: 1e-12, np.float32: 1e-5}


# The mesh layer (phase 19): the rows of the two-rank check and of the
# policy rows, and (label, dtype, P, the kernel its folds must launch) of
# the sharded runs; "matrices" runs sharded_training_matrices, every other
# run sharded_cross_validate_reduce with diag_fn.
MESH_N = 20_000
# the kernels the mesh path must launch (all but the small-fold kernel and
# the slicer, which no gate reaches), and its bound against the single-
# device port in float64, of the largest entry
MESH_KERNELS = ("fused_loocv", "fold_packed", "fold_epilogue",
                "fold_packed_f32", "fold_downdate_f32", "fused_loocv_x2",
                "fused_loocv_sym", "fold_ozaki_df64", "fused_loocv_f32",
                "fused_loocv_f32x2", "fold_v3", "fold_v3_sym")
MESH_RTOL = 1e-10
MESH_FULL = (("LOOCV", np.float64, N, "fused_loocv"),
             ("P=25,000", np.float64, 25_000, "fold_packed"),
             ("P=1,000", np.float64, 1_000, "fold_v3"),
             ("P=100", np.float64, 100, "fold_ozaki_df64"),
             ("P=10", np.float64, 10, "fold_epilogue"),
             ("float32 LOOCV", np.float32, N, "fused_loocv_f32"),
             ("float32 P=25,000", np.float32, 25_000, "fold_packed_f32"),
             ("float32 P=1,000", np.float32, 1_000, "fold_downdate_f32"),
             ("matrices P=1,000", np.float64, 1_000, "fold_v3"))
MESH_SMALL = (("LOOCV", np.float64, MESH_N, "fused_loocv"),
              ("P=5,000", np.float64, 5_000, "fold_packed"),
              ("P=200", np.float64, 200, "fold_v3"),
              ("P=20", np.float64, 20, "fold_ozaki_df64"),
              ("float32 LOOCV", np.float32, MESH_N, "fused_loocv_f32"),
              ("matrices P=200", np.float64, 200, "fold_v3"))
# The policy rows on MESH_N rows: (label, set_routing knobs, dtype, P, the
# kernel, batch_size: even where the two-folds-per-block kernel must run).
MESH_POLICY = (("df64x2 LOOCV", dict(df64x2=True), np.float64, MESH_N,
                "fused_loocv_x2", 1_000),
               ("sym_loocv LOOCV", dict(sym_loocv=True), np.float64, MESH_N,
                "fused_loocv_sym", None),
               ("f32x2 float32 LOOCV", dict(f32x2=True), np.float32, MESH_N,
                "fused_loocv_f32x2", 1_000),
               ("sym_loocv P=200", dict(sym_loocv=True), np.float64, 200,
                "fold_v3_sym", None))


def diag_fn(mats, stats):
    """A fold's reduction on the mesh phase: the diagonal of XTX and the
    first row of XTY (K + M values, which the oracle can check)."""
    return torch.cat([mats[0].diagonal(), mats[1][0]])


def main_data():
    """Phase 4's data: X, Y and the weights from seed 42."""
    rng = np.random.default_rng(SEED)
    X = rng.random((N, K), dtype=np.float64)
    Y = rng.random((N, M), dtype=np.float64)
    return X, Y, rng.random(N)


def run_mesh(mesh, X, Y, w, cases, knobs=None, batch_size=None):
    """Each case through the mesh layer on ``mesh``: ``fit_sharded`` once a
    dtype, then the case, with every launch count at 0 just before it.
    Returns ``{label: (seconds, result on the host, launch counts)}``; the
    result is the reduction (P, K + M) or, for "matrices", the first and
    last folds' [XTX | XTY]."""
    from cvmatrix_tpu_torch import CVConfig, Partitioner, set_routing
    from cvmatrix_tpu_torch.ops import fold_downdate as FD
    from cvmatrix_tpu_torch.ops import loocv as TL
    from cvmatrix_tpu_torch.ops import slice_rows as SR
    from cvmatrix_tpu_torch.parallel import distributed as PD

    states, out = {}, {}
    for label, dt, p, _ in cases:
        cfg = CVConfig(True, True, True, True, ddof=1, dtype=dt)
        if dt not in states:
            states[dt] = PD.fit_sharded(cfg, mesh, *(
                a.astype(dt, copy=False) for a in (X, Y, w)))
        _, idx, mask = Partitioner(np.arange(X.shape[0]) % p).padded_batches()

        def run(st=states[dt], cfg=cfg, idx=idx, mask=mask, label=label):
            if label.startswith("matrices"):
                (xtx, xty), _ = PD.sharded_training_matrices(
                    cfg, st, idx, mask, mesh=mesh)
                return torch.cat([xtx[[0, -1]], xty[[0, -1]]], dim=2)
            return PD.sharded_cross_validate_reduce(
                cfg, st, idx, mask, mesh=mesh, reduce_fn=diag_fn,
                batch_size=batch_size)

        if knobs is not None:
            set_routing(**knobs[label])
        for mod in (FD, TL, SR):
            mod.reset_launch_counts()
        t, res = wall(run)
        out[label] = (t, res.cpu().numpy(), launch_counts(FD, TL, SR))
    return out


def mesh_rank(rank: int, world: int, port: int, out_path: str) -> int:
    """One rank of phase 19's two-rank check: gloo over localhost, the card
    shared; rank 0 writes the results to ``out_path``."""
    import torch.distributed as dist

    from cvmatrix_tpu_torch.parallel import distributed as PD
    from cvmatrix_tpu_torch.parallel import multihost as MH

    MH.initialize(f"tcp://127.0.0.1:{port}", world, rank, backend="gloo",
                  device_type="cuda")
    try:
        X, Y, w = (a[:MESH_N] for a in main_data())
        res = run_mesh(PD.make_mesh("cuda"), X, Y, w, MESH_SMALL)
    finally:
        dist.destroy_process_group()
    for label, (t, _, counts) in res.items():
        log(f"[mesh-rank {rank}] {label}: {t:.4f} s, launches "
            f"{ {n: c for n, c in counts.items() if c} }")
    if rank == 0:
        np.savez(out_path, **{k: v for label, (t, r, counts) in res.items()
                              for k, v in ((label, r), (label + "/t", t), (
                                  label + "/counts", json.dumps(counts)))})
    return 0


def main() -> int:
    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card.", file=sys.stderr)
        return 1
    from cvbench.pls_costs import pls_cost
    from cvmatrix_tpu_torch import (
        CVConfig,
        Partitioner,
        cross_validate_pls,
        fit,
        policy,
        set_routing,
        training_matrices,
    )
    from cvmatrix_tpu_torch.benchmarks import grid as G
    from cvmatrix_tpu_torch.core import batch as TB
    from cvmatrix_tpu_torch.core.batch import (
        loocv_from_sources,
        prepare_loocv_sources,
    )
    from cvmatrix_tpu_torch.models.sweep import (
        chunking,
        cross_validate_reduce,
        materialize_cv,
        materialize_sweep,
        sweep_chunking,
        sweep_last_chunk,
    )
    from cvmatrix_tpu_torch.models import pls as TP
    from cvmatrix_tpu_torch.ops import _build
    from cvmatrix_tpu_torch.ops import fold_downdate as FD
    from cvmatrix_tpu_torch.ops import loocv as TL
    from cvmatrix_tpu_torch.ops import pls as OP
    from cvmatrix_tpu_torch.ops import slice_rows as SR
    from cvmatrix_tpu_torch.ops.loocv import fused_loocv
    from cvmatrix_tpu_torch.ops.precision import highest_precision
    from tests.oracle import NaiveOracle
    from tests.pls_reference import fold_press

    dev = torch.device("cuda", 0)
    card = G.card_line(dev)
    kind = torch.cuda.get_device_name(0)
    nvcc = _build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True,
                              timeout=60).stdout.strip().splitlines()[-1]
    triton = importlib.util.find_spec("triton")
    log(f"[device] {card}")
    log(f"[device] {kind}; {torch.cuda.device_count()} card(s); python "
        f"{sys.version.split()[0]}; torch {torch.__version__}; "
        f"torch.version.cuda {torch.version.cuda}")
    log(f"[device] nvcc {nvcc}: {nvcc_ver}; ninja "
        f"{shutil.which('ninja') or 'absent'}; triton "
        f"{'present' if triton else 'absent'}")

    # ---- 2. build ----------------------------------------------------------
    libs = ("loocv", "fold_downdate", "fold_epilogue", "slice_rows", "pls")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc each, at once
        list(pool.map(_build.load_library, libs))
    log(f"[build] {', '.join(n + '.cu' for n in libs)} -> "
        f"{_build.build_dir()} in {time.perf_counter() - t0:.2f} s "
        "(in parallel)")
    for name in libs:
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            if "Function properties" in line:
                log(f"[build] {name}: {line.split('for ')[-1].strip()}")
            elif "registers" in line or "spill" in line:
                log(f"[build] {name}:   {line.strip()}")

    # ---- 3. kernel against twin -------------------------------------------
    def twin(cfg, state, rows, with_y):
        src = prepare_loocv_sources(cfg, state, rows, return_XTY=with_y)
        got = loocv_from_sources(cfg, src, rows, return_XTY=with_y,
                                 impl="cuda")
        ref = loocv_from_sources(cfg, src, rows, return_XTY=with_y,
                                 impl="torch")
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not err <= TWIN_RTOL * scale:
            raise AssertionError(
                f"kernel vs twin: max|diff| {err:.3e} > {TWIN_RTOL:g} * "
                f"{scale:.3e} ({cfg}, with_y={with_y})"
            )
        return err, err / scale

    rng = np.random.default_rng(SEED)
    n_small = 2_000
    Xs = rng.random((n_small, K))
    Ys = rng.random((n_small, M))
    ws = rng.random(n_small)
    ws[::7] = 0.0
    rows_small = np.sort(rng.choice(n_small, 64, replace=False))
    worst_abs = worst_rel = 0.0
    cases = 0
    for flags in itertools.product([True, False], repeat=4):
        for w in (ws, None):
            cfg = CVConfig(*flags, ddof=1, dtype=np.float64)
            st = fit(cfg, Xs, Ys, w, device=dev)
            with_ys = (True, False) if flags in (
                (True,) * 4, (False,) * 4) else (True,)
            for with_y in with_ys:
                a, r = twin(cfg, st, rows_small, with_y)
                worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
                cases += 1
    log(f"[twin] {cases} small cases (N={n_small}, 64 folds): worst "
        f"max|diff| {worst_abs:.3e}, worst relative {worst_rel:.3e}")

    X, Y, weights = main_data()
    cfg = CVConfig(True, True, True, True, ddof=1, dtype=np.float64)
    Xd, Yd, wd = (torch.from_numpy(a).to(dev) for a in (X, Y, weights))
    st = fit(cfg, Xd, Yd, wd, copy=False)
    for rows in (np.arange(256), np.arange(N - 256, N)):
        a, r = twin(cfg, st, rows, True)
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
        log(f"[twin] full N, folds {rows[0]}..{rows[-1]}: max|diff| "
            f"{a:.3e}, relative {r:.3e}")

    bs, n_chunks = chunking(N, K, K + M)
    rows_chunk = torch.arange(bs, dtype=torch.int64).pin_memory()
    src = prepare_loocv_sources(cfg, st, rows_chunk)
    buf = torch.empty((bs, K, K + M), dtype=torch.float64, device=dev)
    run = {
        impl: (lambda impl=impl: loocv_from_sources(
            cfg, src, rows_chunk, return_XTY=True, impl=impl,
            out=buf if impl == "cuda" else None))
        for impl in ("cuda", "torch")
    }
    chunk_ms = {"torch": [], "cuda": []}
    for impl in ("torch", "cuda", "cuda", "torch"):
        chunk_ms[impl].append(cuda_ms(run[impl], 20 if impl == "cuda" else 3))
    kernel_ms, plain_ms = min(chunk_ms["cuda"]), min(chunk_ms["torch"])
    # kernel -> (ms, plain ms, bound ms, bound by, library ms) of the chunk
    # the kernels line reports
    chunk_times = {"fused_loocv": (kernel_ms, plain_ms,
                                   *bound(*fold_cost(bs, 1, 8, **KC)), None)}
    chunk_bytes = bs * K * (K + M) * 8
    log(f"[twin] one {bs}-fold chunk at K={K}, M={M} ({chunk_bytes / 1e9:.3f} "
        f"GB out): kernel {chunk_ms['cuda']} ms, plain {chunk_ms['torch']} ms "
        f"(plain, kernel, kernel, plain); kernel writes "
        f"{chunk_bytes / kernel_ms / 1e6:.1f} GB/s  [{card}]")
    del src, buf, st

    # ---- 4. main path -------------------------------------------------------
    idx = Partitioner(np.arange(N)).padded_batches()[1]

    def total_cv():
        return float(materialize_cv(cfg, Xd, Yd, wd, idx))

    t_warm, _ = wall(total_cv)
    fused_loocv.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t_total, probe = wall(total_cv)
    launches = fused_loocv.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mat_totals = {(np.float64, N): t_total}  # materialize_cv totals, s
    # bench_torch.py's configurations (phase 22) as an earlier phase ran
    # them: (dtype, (N, K, M, P), sym_loocv) -> (probe, total s, phase)
    bench_ref = {(np.float64, (N, K, M, N), False): (probe, t_total,
                                                      "phase 4")}
    if launches != n_chunks:
        raise AssertionError(
            f"main path launched the LOOCV kernel {launches} times, expected "
            f"{n_chunks} (one per chunk)"
        )
    if not np.isfinite(probe):
        raise AssertionError(f"main-path probe is not finite: {probe}")
    t_fit, st = wall(lambda: fit(cfg, Xd, Yd, wd, copy=False))
    sweeps = {"torch": [], "cuda": []}
    for impl in ("torch", "cuda", "cuda", "torch"):
        sweeps[impl].append(wall(lambda: float(
            materialize_sweep(cfg, st, idx, impl=impl)))[0])
    floor_s = N * K * (K + M) * 8 / 3.35e12
    log(f"[main] weighted TTTT f64 N={N} K={K} M={M} P={N} (LOOCV), "
        f"{n_chunks} chunks of {bs}  [{card}]")
    log(f"[main] materialize_cv: warm-up {t_warm:.4f} s, timed total "
        f"{t_total:.4f} s -> {N / t_total:,.0f} folds/s; probe {probe!r}; "
        f"kernel launches {launches}; peak device memory {peak_gb:.2f} GB")
    log(f"[main] fit alone {t_fit:.4f} s; fold sweep alone: kernel "
        f"{sweeps['cuda']} s, plain twin {sweeps['torch']} s "
        f"(plain, kernel, kernel, plain); write floor at 3.35 TB/s "
        f"{floor_s:.4f} s")

    # ---- 5. oracle ------------------------------------------------------------
    naive = NaiveOracle(True, True, True, True, ddof=1).fit(X, Y, weights)
    all_rows = np.arange(N)

    def oracle(fold):
        (xtx, xty), _ = naive.training_XTX_XTY(np.delete(all_rows, fold))
        return np.concatenate([xtx, xty], axis=1)

    f_probe = (n_chunks - 1) * bs
    ref = oracle(f_probe)
    expect = float(ref[0, 0] + ref[0, K])
    if not abs(probe - expect) <= ORACLE_RTOL * abs(expect):
        raise AssertionError(f"probe {probe!r} vs oracle {expect!r} (fold "
                             f"{f_probe})")
    log(f"[oracle] main-path probe (fold {f_probe}) {probe!r} vs oracle "
        f"{expect!r}: relative {abs(probe - expect) / abs(expect):.3e}")
    folds = np.array([0, N - 1])
    src = prepare_loocv_sources(cfg, st, folds)
    got = loocv_from_sources(cfg, src, folds, return_XTY=True,
                             impl="cuda").cpu().numpy()
    for i, fold in enumerate(folds):
        ref = oracle(fold)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got[i], ref, rtol=ORACLE_RTOL,
                                   atol=ORACLE_RTOL * scale)
        log(f"[oracle] fold {fold}: max|kernel - oracle| "
            f"{np.abs(got[i] - ref).max():.3e} (max|oracle| {scale:.3e})")

    # ---- 6. K-fold kernels against twins -----------------------------------
    def batch(cfg, state, idx, mask, xtx, xty, impl):
        mats, _ = TB.training_matrices_batched(
            cfg, state, idx, mask, return_XTX=xtx, return_XTY=xty, impl=impl)
        return torch.cat(mats, dim=2) if isinstance(mats, tuple) else mats

    fold_err = {w: 0.0 for w in ROUTE_WRAPPER.values()}
    fold_rel = dict(fold_err)
    rng = np.random.default_rng(SEED + 1)
    fold_batches = []
    for n_l, n_folds in ((4, 16), (100, 8), (1000, 2), (1025, 2)):
        idx = np.stack([rng.choice(n_small, n_l, replace=False)
                        for _ in range(n_folds)])
        mask = np.ones(idx.shape)
        mask[::2, -max(1, n_l // 10):] = 0.0
        fold_batches += [(idx, None), (idx, mask)]
    cases = 0
    for flags in itertools.product([True, False], repeat=4):
        for w in (ws, None):
            cfg_s = CVConfig(*flags, ddof=1, dtype=np.float64)
            st_s = fit(cfg_s, Xs, Ys, w, device=dev)
            sides = [(True, True), (True, False)]
            if flags in ((True,) * 4, (False,) * 4):
                sides.append((False, True))
            for (xtx, xty), (idx, mask) in itertools.product(sides,
                                                             fold_batches):
                route = TB.route_kernel(cfg_s, st_s, idx.shape[1], xtx, xty,
                                        mask is not None)
                before = FD.launch_counts()
                got = batch(cfg_s, st_s, idx, mask, xtx, xty, "cuda")
                after = FD.launch_counts()
                ref = batch(cfg_s, st_s, idx, mask, xtx, xty, "torch")
                torch.cuda.synchronize()
                launched = {n for n in after if after[n] != before[n]}
                if launched != {ROUTE_WRAPPER[route]}:
                    raise AssertionError(
                        f"L={idx.shape[1]} ({route}) launched {launched}")
                err = (got - ref).abs().max().item()
                scale = ref.abs().max().item()
                if not err <= TWIN_RTOL * scale:
                    raise AssertionError(
                        f"{route} kernel vs twin: max|diff| {err:.3e} > "
                        f"{TWIN_RTOL:g} * {scale:.3e} ({cfg_s}, L="
                        f"{idx.shape[1]}, mask={mask is not None}, "
                        f"xtx={xtx}, xty={xty})")
                name = ROUTE_WRAPPER[route]
                fold_err[name] = max(fold_err[name], err)
                fold_rel[name] = max(fold_rel[name], err / scale)
                cases += 1
    log(f"[kfold-twin] {cases} cases (N={n_small}; L=4, 100, 1000, 1025, "
        f"each unmasked and masked): worst max|diff| {fold_err}, worst "
        f"relative {fold_rel}")

    def v3_args(src):
        """``fold_v3``'s operands from ``OzakiSources``."""
        return (src.total, src.xw, src.xu, src.yu, src.rows, src.mask,
                src.gx, src.sxv, src.yvec, src.scal)

    def v3_flags(cfg_v, with_y):
        return dict(center_xtx=cfg_v.center_X,
                    center_xty=cfg_v.center_X or cfg_v.center_Y,
                    scale_x=cfg_v.scale_X, scale_y=cfg_v.scale_Y,
                    with_y=with_y, resolution=cfg_v.resolution)

    def sym_checks(label, got, full):
        """The symmetric kernel's X block exactly symmetric, and its upper
        triangle and XTY columns the full kernel's bit for bit."""
        k_s = got.shape[1]
        x = got[:, :, :k_s]
        iu_s = torch.triu_indices(k_s, k_s, device=got.device)
        if not torch.equal(x, x.mT):
            raise AssertionError(f"{label}: X block not exactly symmetric")
        if not (torch.equal(got[:, iu_s[0], iu_s[1]],
                            full[:, iu_s[0], iu_s[1]])
                and torch.equal(got[:, :, k_s:], full[:, :, k_s:])):
            raise AssertionError(f"{label}: upper entries differ from the "
                                 "full tile's")

    # The tensor-core tile's edges, through fold_ozaki_df64, fold_v3 and
    # fold_v3(sym=True): ragged L, K=37 with M=0 (8-byte copies, XTX alone),
    # XTY alone (no v3), one fold, masked and unmasked; one launch of the
    # wrapper's counter each; the symmetric X blocks exactly symmetric and
    # their upper entries bit-equal to the full tile's.
    rng = np.random.default_rng(SEED + 5)
    edge_err = {"fold_ozaki_df64": 0.0, "fold_v3": 0.0, "fold_v3_sym": 0.0}
    fold_err["fold_v3_sym"] = fold_rel["fold_v3_sym"] = 0.0
    cases = 0
    for flags, w in itertools.product(((True,) * 4, (False,) * 4),
                                      (ws, None)):
        cfg_s = CVConfig(*flags, ddof=1, dtype=np.float64)
        for k_e, m_e, xtx in ((K, M, True), (37, 0, True), (K, M, False)):
            st_s = fit(cfg_s, Xs[:, :k_e], Ys if m_e else None, w,
                       device=dev)
            xty = m_e > 0
            total_s = TB._total(st_s, xtx, xty)
            xw_s = st_s.X if st_s.weights is None else st_s.WX
            for n_l in TILE_EDGE_L:
                f_e = 1 if n_l in (3, 1003) else 4
                idx = np.stack([rng.choice(n_small, n_l, replace=False)
                                for _ in range(f_e)])
                mask = np.ones(idx.shape)
                mask[::2, -max(1, n_l // 10):] = 0.0
                for mk in (None, mask):
                    rows, mask_d = TB._rows_mask(cfg_s, st_s, idx, mk)
                    stats5 = TB._summed_stats(cfg_s, st_s, rows, mask_d,
                                              **TB._stat_flags(cfg_s, xtx,
                                                               xty))
                    kvec, cvec = TB._reference_vectors(
                        cfg_s, st_s, stats5, st_s.X.new_empty((f_e, 0)), xtx,
                        xty)
                    runs = {"fold_ozaki_df64": lambda impl: FD.fold_ozaki_df64(
                        total_s, xw_s, st_s.X, st_s.Y if xty else None, rows,
                        mask_d, kvec, cvec, with_x=xtx, impl=impl)}
                    if xtx:
                        vsrc = TB.prepare_ozaki_sources(cfg_s, st_s, idx, mk,
                                                        return_XTY=xty)
                        runs["fold_v3"] = lambda impl: (
                            TB.ozaki_v3_from_sources(cfg_s, vsrc,
                                                     return_XTY=xty,
                                                     impl=impl))
                        runs["fold_v3_sym"] = lambda impl: FD.fold_v3(
                            *v3_args(vsrc), **v3_flags(cfg_s, xty),
                            sym=True, impl=impl)
                    outs = {}
                    for name, run in runs.items():
                        label = (f"{cfg_s}, K={k_e}, M={m_e}, xtx={xtx}, "
                                 f"L={n_l}, F={f_e}, mask={mk is not None}")
                        before = launch_counts(FD, TL, SR)
                        got = run("cuda")
                        after = launch_counts(FD, TL, SR)
                        moved = {n: after[n] - before[n] for n in after
                                 if after[n] != before[n]}
                        if moved != {name: 1}:
                            raise AssertionError(f"{label}: launched {moved}")
                        ref = run("torch")
                        torch.cuda.synchronize()
                        err = (got - ref).abs().max().item()
                        scale = ref.abs().max().item()
                        if not err <= TWIN_RTOL * scale:
                            raise AssertionError(
                                f"{label}: {name} kernel vs twin max|diff| "
                                f"{err:.3e} > {TWIN_RTOL:g} * {scale:.3e}")
                        if name == "fold_v3_sym":
                            sym_checks(label, got, outs["fold_v3"])
                        outs[name] = got
                        fold_err[name] = max(fold_err[name], err)
                        fold_rel[name] = max(fold_rel[name], err / scale)
                        edge_err[name] = max(edge_err[name], err / scale)
                        cases += 1
    log(f"[tile-edges] {cases} cases of the tensor-core tile (N={n_small}; "
        f"L={list(TILE_EDGE_L)}; K={K}, M={M} and K=37, M=0; XTY alone; "
        f"F=1 and 4; unmasked and masked; TTTT and FFFF, weighted and not; "
        f"symmetric v3 exactly symmetric, its upper entries the full "
        f"tile's bit for bit): worst relative {edge_err}")

    def rowstream_edges(dtype):
        """The row-stream tile through ``fold_packed`` (the route's own
        operands) and ``fold_smallfold`` at its edges: L in ROW_EDGE_L;
        [XTX | XTY] at K=37, M=3 and K=500, M=10, XTX alone at K=37 and
        XTY alone (C=3, packed); one fold and 67; masked (padded slots at
        index 0) and not; operands, rows and out as fold-offset views of a
        larger batch (narrower stores) and not. One launch a call, a second
        call bit-equal, 1e-12 (float64) or 1e-4 (float32) of the twin's
        largest entry; logs the worst relative error of each kernel."""
        f64 = dtype == np.float64
        rtol = TWIN_RTOL if f64 else F32_TWIN_RTOL
        sfx = "" if f64 else "_f32"
        worst = {"fold_packed" + sfx: 0.0, "fold_smallfold" + sfx: 0.0}
        for name in worst:
            fold_err.setdefault(name, 0.0)
            fold_rel.setdefault(name, 0.0)
        cfg_e = CVConfig(True, True, True, True, ddof=1, dtype=dtype)
        rng_e = np.random.default_rng(SEED + 6)

        def check(name, label, run):
            got = []
            for _ in range(2):
                before = launch_counts(FD, TL, SR)
                got.append(run("cuda").clone())
                after = launch_counts(FD, TL, SR)
                moved = {n: after[n] - before[n] for n in after
                         if after[n] != before[n]}
                if moved != {name: 1}:
                    raise AssertionError(f"{label}: launched {moved}")
            ref = run("torch")
            torch.cuda.synchronize()
            if not torch.equal(*got):
                raise AssertionError(f"{label}: a second call differs")
            err = (got[0] - ref).abs().max().item()
            scale = ref.abs().max().item()
            if not err <= rtol * scale:
                raise AssertionError(f"{label}: {name} kernel vs twin "
                                     f"max|diff| {err:.3e} > {rtol:g} * "
                                     f"{scale:.3e}")
            fold_err[name] = max(fold_err[name], err)
            fold_rel[name] = max(fold_rel[name], err / scale)
            worst[name] = max(worst[name], err / scale)

        cases = 0
        for k_e, m_e in ((37, 3), (37, 0), (K, M)):
            st_e = fit(cfg_e, Xs[:, :k_e].astype(dtype),
                       Ys[:, :m_e].astype(dtype) if m_e else None,
                       ws.astype(dtype), device=dev)
            sides = ((True, True), (False, True)) if m_e else ((True, False),)
            if k_e == K:
                sides = sides[:1]
            for n_l, f_e, masked, view in itertools.product(
                    ROW_EDGE_L, (1, 67), (False, True), (0, 1)):
                idx = rng_e.integers(0, n_small, (f_e + view, n_l))
                mask = None
                if masked:
                    mask = np.ones(idx.shape)
                    mask[::2, -max(1, n_l // 3):] = 0.0
                    idx[mask == 0] = 0  # padded slots
                label = (f"row-stream {dtype.__name__} K={k_e}, M={m_e}, "
                         f"L={n_l}, F={f_e}, masked={masked}, view={view}")
                for xtx, xty in sides:
                    ops_e = TB.slice_operands(TB.prepare_fold_operands(
                        cfg_e, st_e, idx, mask, return_XTX=xtx,
                        return_XTY=xty)[0], view, f_e)
                    out_e = torch.empty(
                        (f_e + view, k_e, ops_e.total.shape[1]),
                        dtype=st_e.X.dtype, device=dev)
                    check("fold_packed" + sfx, f"{label}, xtx={xtx}",
                          lambda impl: TB.downdate_from_operands(
                              ops_e, impl=impl,
                              out=out_e[view:] if impl == "cuda" else None))
                    cases += 1
                src_e = prepare_loocv_sources(cfg_e, st_e, idx, mask,
                                              return_XTY=m_e > 0)
                out_e = torch.empty((f_e + view, k_e, k_e + m_e),
                                    dtype=st_e.X.dtype, device=dev)
                check("fold_smallfold" + sfx, label,
                      lambda impl: TB.smallfold_from_sources(
                          cfg_e, src_e, src_e.rows[view:], src_e.scal[view:],
                          None if mask is None else src_e.mask[view:],
                          n_l=n_l, return_XTY=m_e > 0, has_mask=masked,
                          impl=impl,
                          out=out_e[view:] if impl == "cuda" else None))
                cases += 1
        log(f"[row-edges] {cases} cases of the row-stream tile in "
            f"{dtype.__name__} (N={n_small}; L={list(ROW_EDGE_L)}; K=37 with "
            f"M=3 and M=0, XTY alone, K={K}, M={M}; F=1 and 67; masked and "
            f"not; fold-offset views and not): worst relative {worst}, a "
            f"second call bit-equal, one launch a call")

    rowstream_edges(np.float64)

    def chunk_idx(p):
        _, idx, mask = Partitioner(np.arange(N) % p).padded_batches()
        bs_p, n_chunks_p = chunking(p, K, K + M)
        return idx, mask, bs_p, n_chunks_p

    def hold(label, name, got, ref, rtol=TWIN_RTOL):
        """A full-width chunk through the kernel against its twin; the
        error joins the kernel's worst case."""
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not err <= rtol * scale:
            raise AssertionError(
                f"{label}: {name} kernel vs twin max|diff| {err:.3e} > "
                f"{rtol:g} * {scale:.3e}")
        fold_err[name] = max(fold_err[name], err)
        fold_rel[name] = max(fold_rel[name], err / scale)
        log(f"[kfold-chunk] {label}: {name} kernel vs twin max|diff| "
            f"{err:.3e}, relative {err / scale:.3e}")

    def time_pair(label, name, kernel_fn, plain_fn, n_out, itemsize=8,
                  flops=None):
        ms = {"torch": [], "cuda": []}
        for impl in ("torch", "cuda", "cuda", "torch"):
            fn = kernel_fn if impl == "cuda" else plain_fn
            ms[impl].append(cuda_ms(fn, 10 if impl == "cuda" else 3))
        gb = n_out * itemsize / 1e9
        rate = ("" if flops is None else
                f", {flops / min(ms['cuda']) / 1e9:.1f} TFLOP/s")
        log(f"[kfold-chunk] {label}: {name} kernel {ms['cuda']} ms, plain "
            f"{ms['torch']} ms (plain, kernel, kernel, plain); "
            f"{gb:.3f} GB out, kernel writes "
            f"{gb / min(ms['cuda']) * 1e3:.1f} GB/s{rate}  [{card}]")
        return min(ms["cuda"]), min(ms["torch"])

    def time_turns(label, fns, reps, tag="policy-chunk"):
        """CUDA-event ms of each of ``fns`` ({name: fn}), in turns, there
        and back; the best of the two."""
        order = list(fns) + list(fns)[::-1]
        ms = {n: [] for n in fns}
        for n in order:
            ms[n].append(cuda_ms(fns[n], reps[n]))
        log(f"[{tag}] {label}: " + ", ".join(
            f"{n} {ms[n]} ms" for n in fns) + f" (order {order})  [{card}]")
        return {n: min(v) for n, v in ms.items()}

    def store_chunk(label, fns, buf, cost):
        """A store-bound chunk (``fns``: "plain", "kernel", "torch.bmm" and
        any others) timed in turns beside a pure write of its output bytes
        (``buf.fill_``): the store rate this card reaches, logged as a
        ceiling beside the bound at 3.35 TB/s, never in its place."""
        with highest_precision():  # torch.bmm in full float32
            ms = time_turns(label, {**fns, "fill_": lambda: buf.fill_(1.0)},
                            {n: 3 if n == "plain" else 10
                             for n in (*fns, "fill_")}, tag="store-chunk")
        gb = buf.numel() * buf.element_size() / 1e9
        b = bound(*cost)
        log(f"[store-chunk] {label}: kernel {ms['kernel']:.4f} ms "
            f"({gb / ms['kernel']:.2f} TB/s of stores), torch.bmm "
            f"{ms['torch.bmm']:.4f} ms ({gb / ms['torch.bmm']:.2f} TB/s), "
            f"pure write {ms['fill_']:.4f} ms ({gb / ms['fill_']:.2f} TB/s: "
            f"the ceiling); bound {b[0]:.4f} ms ({b[1]}, 3.35 TB/s)  "
            f"[{card}]")
        return ms

    def epilogue_chunk(label, total, prod, kvec, cvec):
        """The in-place epilogue over a product chunk (F, K, C), timed in
        turns with its twin and with a same-traffic ceiling: one in-place
        PyTorch elementwise call over the same bytes, ``prod.sub_(total)``
        (the product read and rewritten, total read, broadcast over the
        folds), which computes another function and so is no library
        counterpart. A product smaller than twice the L2 is timed over
        copies, each call taking the next, so that none is still in L2
        when its turn comes again and the time reads against the
        device-memory bound (on the main path the ``bmm`` has just written
        the product, so part of it may still be there). -> the kernels
        line's (ms, plain ms, bound ms, bound by, library ms)."""
        f, k, c = prod.shape
        l2 = torch.cuda.get_device_properties(dev).L2_cache_size
        nbytes = prod.numel() * prod.element_size()
        n_copies = 1 if nbytes >= 2 * l2 else 1 + -(-3 * l2 // nbytes)
        prods = [prod] + [prod.clone() for _ in range(n_copies - 1)]
        turn = {n: itertools.cycle(prods) for n in ("plain", "kernel", "sub_")}
        ms = time_turns(f"{label} ({n_copies} product copies)", {
            "plain": lambda: FD.fold_epilogue(total, next(turn["plain"]),
                                              kvec, cvec, impl="torch"),
            "kernel": lambda: FD.fold_epilogue(total, next(turn["kernel"]),
                                               kvec, cvec, impl="cuda"),
            "sub_": lambda: next(turn["sub_"]).sub_(total)},
            {"plain": 3, "kernel": 10, "sub_": 10}, tag="epilogue-chunk")
        del prods, turn
        cost = epilogue_cost(f, k=k, c=c)
        b = bound(*cost)
        tb = cost[0] / 1e9
        log(f"[epilogue-chunk] {label}: kernel {ms['kernel']:.4f} ms "
            f"({tb / ms['kernel']:.2f} TB/s, {b[0] / ms['kernel']:.1%} of "
            f"the bound), same-traffic ceiling prod.sub_(total) "
            f"{ms['sub_']:.4f} ms ({tb / ms['sub_']:.2f} TB/s), plain "
            f"{ms['plain']:.4f} ms; bound {b[0]:.4f} ms ({b[1]}: "
            f"{tb:.3f} GB at 3.35 TB/s)  [{card}]")
        return ms["kernel"], ms["plain"], *b, None

    def product_flops(f, n_l):
        return 2 * f * n_l * K * (K + M)

    def library_ms(a, b, reps=10):
        """``torch.bmm`` of the gathered blocks: the one PyTorch call that
        computes the product (timed here; the port never calls it)."""
        with highest_precision():
            return cuda_ms(lambda: torch.bmm(a.mT, b), reps)

    def gathered_blocks(state, rows):
        rows = torch.as_tensor(rows, device=dev)
        return state.WX[rows], torch.cat([state.X[rows], state.Y[rows]], 2)

    # Each route's first full-width chunk of the phase 7 sweeps, through
    # the kernel and the twin: held at the bound, then timed.
    idx, _, bs_p, _ = chunk_idx(25_000)
    ops, _ = TB.prepare_fold_operands(cfg, st, idx[:bs_p])
    buf = torch.empty((bs_p, K, K + M), dtype=torch.float64, device=dev)
    label = f"P=25,000 chunk of {bs_p} folds x L=4"
    run = {impl: (lambda impl=impl: TB.downdate_from_operands(
        ops, impl=impl, out=buf if impl == "cuda" else None))
        for impl in ("cuda", "torch")}
    hold(label, "fold_packed", run["cuda"](), run["torch"]())
    cost = fold_cost(bs_p, 4, 8, gathered=False, **KC)
    ms = store_chunk(label + ", packed float64", {
        "plain": run["torch"], "kernel": run["cuda"],
        "torch.bmm": lambda: torch.bmm(ops.u.mT, ops.v)}, buf, cost)
    chunk_times["fold_packed"] = (ms["kernel"], ms["plain"], *bound(*cost),
                                  ms["torch.bmm"])
    del ops, run
    for p in (1_000, 10_000):
        idx, _, bs_p, _ = chunk_idx(p)
        src = TB.prepare_ozaki_sources(cfg, st, idx[:bs_p])
        buf = torch.empty((bs_p, K, K + M), dtype=torch.float64, device=dev)
        label = f"P={p:,} chunk of {bs_p} folds x L={idx.shape[1]}"
        run = {impl: (lambda impl=impl: TB.ozaki_v3_from_sources(
            cfg, src, return_XTY=True, impl=impl,
            out=buf if impl == "cuda" else None))
            for impl in ("cuda", "torch")}
        hold(label, "fold_v3", run["cuda"](), run["torch"]())
        pair = time_pair(label, "fold_v3", run["cuda"], run["torch"],
                         buf.numel(), flops=product_flops(bs_p, idx.shape[1]))
        lib = library_ms(*gathered_blocks(st, idx[:bs_p]))
        log(f"[kfold-chunk] {label}: torch.bmm of the gathered blocks "
            f"{lib:.4f} ms  [{card}]")
        if p == 1_000:  # the kernels line reports the product-bound chunk
            chunk_times["fold_v3"] = (
                *pair, *bound(*fold_cost(bs_p, idx.shape[1], 8, **KC)), lib)
        del src, run
    total = torch.cat([st.XTX, st.XTY], dim=1)
    flags = TB._stat_flags(cfg, True, True)
    for p, name in ((100, "fold_ozaki_df64"), (10, "fold_epilogue"),
                    (3, "fold_epilogue")):
        idx, mask, bs_p, _ = chunk_idx(p)
        rows, mask_d = TB._rows_mask(cfg, st, idx[:bs_p],
                                     None if mask is None else mask[:bs_p])
        label = (f"P={p:,} chunk of {bs_p} folds x L={idx.shape[1]}"
                 f"{', masked' if mask is not None else ''}")
        like = st.X.new_empty((bs_p, 0))
        if name == "fold_ozaki_df64":
            stats5 = TB._summed_stats(cfg, st, rows, mask_d, **flags)
            kvec, cvec = TB._reference_vectors(cfg, st, stats5, like, True,
                                                True)
            buf = torch.empty((bs_p, K, K + M), dtype=torch.float64,
                              device=dev)
            run = {impl: (lambda impl=impl: FD.fold_ozaki_df64(
                total, st.WX, st.X, st.Y, rows, mask_d, kvec, cvec,
                impl=impl, out=buf if impl == "cuda" else None))
                for impl in ("cuda", "torch")}
            hold(label, name, run["cuda"](), run["torch"]())
            lib = library_ms(*gathered_blocks(st, idx[:bs_p]))
            chunk_times[name] = (
                *time_pair(label, name, run["cuda"], run["torch"],
                           buf.numel(),
                           flops=product_flops(bs_p, idx.shape[1])),
                *bound(*fold_cost(bs_p, idx.shape[1], 8, **KC)), lib)
            log(f"[kfold-chunk] {label}: torch.bmm of the gathered blocks "
                f"{lib:.4f} ms  [{card}]")
            del run
            continue
        blocks, stats5 = TB._gather_and_stats(cfg, st, rows, mask_d, True,
                                              True)
        kvec, cvec = TB._reference_vectors(cfg, st, stats5, like, True, True)
        prod = torch.bmm(blocks.Xv_w.mT,
                         torch.cat([blocks.Xv_u, blocks.Yv_u], dim=2))
        # in place: each side rewrites its own copy of the product
        hold(label, name,
             FD.fold_epilogue(total, prod.clone(), kvec, cvec, impl="cuda"),
             FD.fold_epilogue(total, prod.clone(), kvec, cvec, impl="torch"))
        if p == 10:
            chunk_times[name] = epilogue_chunk(
                label + ", epilogue over the product", total, prod, kvec,
                cvec)
        del prod, blocks, stats5
    buf = None

    # ---- 7. K-fold path at full width ----------------------------------------
    kfold_launches = {w: 0 for w in ROUTE_WRAPPER.values()}
    probes = {}
    log(f"[kfold] weighted TTTT f64 N={N} K={K} M={M}, "
        f"Partitioner(np.arange(N) % P)  [{card}]")
    for p, expect in KFOLD_P:
        idx, mask, bs_p, n_chunks_p = chunk_idx(p)

        def cv(idx=idx, mask=mask):
            return float(materialize_cv(cfg, Xd, Yd, wd, idx, mask))

        t_warm, _ = wall(cv)
        FD.reset_launch_counts()
        fused_loocv.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t_total, probe = wall(cv)
        counts = FD.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if (counts[expect] != n_chunks_p or fused_loocv.launches
                or any(v for n, v in counts.items() if n != expect)):
            raise AssertionError(
                f"P={p}: launches {counts}, fused_loocv "
                f"{fused_loocv.launches}; expected {n_chunks_p} of {expect}")
        if not np.isfinite(probe):
            raise AssertionError(f"P={p}: probe is not finite: {probe}")
        kfold_launches[expect] += counts[expect]
        mat_totals[(np.float64, p)] = t_total
        if mask is None:  # one fold size: the bench's one materialize_cv
            bench_ref[np.float64, (N, K, M, p), False] = (probe, t_total,
                                                          "phase 7")
        sweeps = {"torch": [], "cuda": []}
        for impl in ("torch", "cuda"):
            sweeps[impl].append(wall(lambda impl=impl: float(
                materialize_sweep(cfg, st, idx, mask, impl=impl)))[0])
        gb = p * K * (K + M) * 8 / 1e9
        floor_s = gb * 1e9 / 3.35e12
        log(f"[kfold] P={p:,} (L={idx.shape[1]}{', masked' if mask is not None else ''}"
            f", {n_chunks_p} chunks of {bs_p}): total {t_total:.4f} s "
            f"(warm-up {t_warm:.4f} s) -> {p / t_total:,.0f} folds/s; "
            f"{expect} launches {counts[expect]}; {gb:.2f} GB written, "
            f"write floor {floor_s:.4f} s = {floor_s / t_total:.1%} of the "
            f"total; peak {peak_gb:.2f} GB; sweep alone: kernel "
            f"{sweeps['cuda'][0]:.4f} s, plain {sweeps['torch'][0]:.4f} s; "
            f"probe {probe!r}")
        probes[p] = (probe, idx, mask, min((n_chunks_p - 1) * bs_p, p - 1))

    # ---- 8. K-fold oracle -----------------------------------------------------
    for p, (probe, idx, mask, f) in probes.items():
        rows_f = idx[f] if mask is None else idx[f][mask[f] > 0]
        (xtx, xty), _ = naive.training_XTX_XTY(np.delete(all_rows, rows_f))
        ref = np.concatenate([xtx, xty], axis=1)
        expect = float(ref[0, 0] + ref[0, K])
        if not abs(probe - expect) <= ORACLE_RTOL * abs(expect):
            raise AssertionError(f"P={p}: probe {probe!r} vs oracle "
                                 f"{expect!r} (fold {f})")
        got = batch(cfg, st, idx[f:f + 1],
                    None if mask is None else mask[f:f + 1], True, True,
                    "cuda")[0].cpu().numpy()
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=ORACLE_RTOL,
                                   atol=ORACLE_RTOL * scale)
        log(f"[oracle] P={p:,} fold {f} ({rows_f.size} rows): probe "
            f"relative {abs(probe - expect) / abs(expect):.3e}; "
            f"max|port - oracle| {np.abs(got - ref).max():.3e} "
            f"(max|oracle| {scale:.3e})")

    # ---- 9. float32 kernels against twins ------------------------------------
    for name in ROUTE_WRAPPER_F32.values():
        fold_err[name] = fold_rel[name] = 0.0
    rng = np.random.default_rng(SEED + 2)

    def folds(n_l, n_folds):
        return np.stack([rng.choice(n_small, n_l, replace=False)
                         for _ in range(n_folds)])

    one = np.sort(rng.choice(n_small, 64, replace=False))[:, None]
    mask_one = np.ones(one.shape)
    mask_one[::4] = 0.0
    big = folds(1025, 2)
    mask_big = np.ones(big.shape)
    mask_big[::2, -100:] = 0.0
    f32_batches = [(one, None), (one, mask_one), (folds(4, 16), None),
                   (folds(100, 8), None), (big, mask_big)]
    Xs32, Ys32, ws32 = (a.astype(np.float32) for a in (Xs, Ys, ws))
    # fused_downdate's kernel and twin, each against the float64 engine on
    # the same float32 data (worst relative to its largest entry)
    vs64 = {"kernel": 0.0, "twin": 0.0}
    cases = 0
    for flags in itertools.product([True, False], repeat=4):
        for w in (ws32, None):
            cfg_s = CVConfig(*flags, ddof=1, dtype=np.float32)
            st_s = fit(cfg_s, Xs32, Ys32, w, device=dev)
            cfg_d = CVConfig(*flags, ddof=1)
            st_d = fit(cfg_d, Xs32.astype(np.float64), Ys32.astype(np.float64),
                       None if w is None else w.astype(np.float64),
                       device=dev)
            for (xtx, xty), (idx, mask) in itertools.product(
                    ((True, True), (True, False), (False, True)),
                    f32_batches):
                route = TB.route_kernel(cfg_s, st_s, idx.shape[1], xtx, xty,
                                        mask is not None)
                name = ROUTE_WRAPPER_F32[route]
                before = launch_counts(FD, TL, SR)
                got = batch(cfg_s, st_s, idx, mask, xtx, xty, "cuda")
                after = launch_counts(FD, TL, SR)
                ref = batch(cfg_s, st_s, idx, mask, xtx, xty, "torch")
                torch.cuda.synchronize()
                launched = {n for n in after if after[n] != before[n]}
                if launched != {name} or got.dtype != torch.float32:
                    raise AssertionError(
                        f"f32 L={idx.shape[1]} ({route}) launched {launched}"
                        f", output {got.dtype}")
                err = (got - ref).abs().max().item()
                scale = ref.abs().max().item()
                if not err <= F32_TWIN_RTOL * scale:
                    raise AssertionError(
                        f"{route} kernel vs twin: max|diff| {err:.3e} > "
                        f"{F32_TWIN_RTOL:g} * {scale:.3e} ({cfg_s}, L="
                        f"{idx.shape[1]}, mask={mask is not None}, "
                        f"xtx={xtx}, xty={xty})")
                fold_err[name] = max(fold_err[name], err)
                fold_rel[name] = max(fold_rel[name], err / scale)
                if name == "fold_downdate_f32":
                    ref64 = batch(cfg_d, st_d, idx, mask, xtx, xty, "torch")
                    scale64 = ref64.abs().max().item()
                    for who, val in (("kernel", got), ("twin", ref)):
                        vs64[who] = max(vs64[who], (val.double() - ref64)
                                        .abs().max().item() / scale64)
                cases += 1
    log(f"[f32-twin] {cases} cases (N={n_small}; L=1, masked L=1, L=4, 100, "
        f"masked L=1,025): worst max|diff| "
        f"{ {n: fold_err[n] for n in ROUTE_WRAPPER_F32.values()} }, worst "
        f"relative { {n: fold_rel[n] for n in ROUTE_WRAPPER_F32.values()} }; "
        f"fold_downdate_f32 against the float64 engine on the same data, "
        f"worst relative kernel {vs64['kernel']:.3e}, twin "
        f"{vs64['twin']:.3e}")

    # The float32 stream tile's edges, on seeded streams: few folds of
    # L=33,334 and 1,025 (masked rows zero in xv) split across blocks, L=32
    # and 100 unsplit, and widths that take 4-, 8- and 16-byte copies; one
    # launch a call, and the same bits from a second call. The kernel and
    # the twin are each also read against the same formula in float64.
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    f32_edge = 0.0
    vs64 = {"kernel": 0.0, "twin": 0.0}
    cases = 0
    for f_e, n_l, k_e, c_e in ((1, 33_334, K, K + M), (2, 33_334, K, K + M),
                               (3, 33_334, K, K + M), (2, 1_025, K, K + M),
                               (8, 32, K, K + M), (8, 100, K, K + M),
                               (5, 100, 37, 43), (5, 100, 48, 52)):
        splits = FD.downdate_f32_splits(f_e, k_e, c_e, n_l, n_sm)
        if (splits > 1) != (n_l > 1_000):
            raise AssertionError(f"f32 edge F={f_e}, L={n_l}: {splits} "
                                 "splits")
        ops = [torch.from_numpy(rng.random(s, dtype=np.float32)).to(dev)
               for s in ((k_e, c_e), (f_e, n_l, k_e), (f_e, n_l, c_e),
                         (f_e, 2, k_e), (f_e, 2, c_e))]
        ops[0] *= n_l
        for masked in (False, True):
            if masked:
                ops[1][::2, -n_l // 10:] = 0.0
            label = (f"f32 stream tile F={f_e}, L={n_l}, K={k_e}, C={c_e}, "
                     f"masked={masked}, {splits} split(s)")
            got = []
            for _ in range(2):
                before = launch_counts(FD, TL, SR)
                got.append(FD.fold_downdate_f32(*ops, impl="cuda"))
                after = launch_counts(FD, TL, SR)
                moved = {n: after[n] - before[n] for n in after
                         if after[n] != before[n]}
                if moved != {"fold_downdate_f32": 1}:
                    raise AssertionError(f"{label}: launched {moved}")
            ref = FD.fold_downdate_f32(*ops, impl="torch")
            torch.cuda.synchronize()
            if not torch.equal(*got):
                raise AssertionError(f"{label}: a second call differs")
            err = (got[0] - ref).abs().max().item()
            scale = ref.abs().max().item()
            if not err <= F32_TWIN_RTOL * scale:
                raise AssertionError(f"{label}: kernel vs twin max|diff| "
                                     f"{err:.3e} > {F32_TWIN_RTOL:g} * "
                                     f"{scale:.3e}")
            fold_err["fold_downdate_f32"] = max(
                fold_err["fold_downdate_f32"], err)
            f32_edge = max(f32_edge, err / scale)
            ref64 = FD.downdate_f32_reference(*(o.double() for o in ops))
            scale64 = ref64.abs().max().item()
            for who, val in (("kernel", got[0]), ("twin", ref)):
                vs64[who] = max(vs64[who], (val.double() - ref64).abs().max()
                                .item() / scale64)
            cases += 1
            del ref64
        del ops, got, ref
    log(f"[f32-edges] {cases} cases of the float32 stream tile (F=1, 2, 3 "
        f"at L=33,334 and F=2 at L=1,025 split; L=32 and 100 unsplit; K=37, "
        f"C=43 and K=48, C=52; unmasked and masked): worst relative "
        f"{f32_edge:.3e}, a second call bit-equal, one launch a call; "
        f"against float64, worst relative kernel {vs64['kernel']:.3e}, "
        f"twin {vs64['twin']:.3e}")
    rowstream_edges(np.float32)

    # ---- 10. float32 LOOCV main path -----------------------------------------
    cfg32 = CVConfig(True, True, True, True, ddof=1, dtype=np.float32)
    X32, Y32, w32 = (a.astype(np.float32) for a in (X, Y, weights))
    Xd32, Yd32, wd32 = (torch.from_numpy(a).to(dev) for a in (X32, Y32, w32))
    st32 = fit(cfg32, Xd32, Yd32, wd32, copy=False)
    src = prepare_loocv_sources(cfg32, st32, rows_chunk)
    buf = torch.empty((bs, K, K + M), dtype=torch.float32, device=dev)
    run = {impl: (lambda impl=impl: loocv_from_sources(
        cfg32, src, rows_chunk, return_XTY=True, impl=impl,
        out=buf if impl == "cuda" else None))
        for impl in ("cuda", "torch")}
    label = f"f32 LOOCV chunk of {bs} folds"
    hold(label, "fused_loocv_f32", run["cuda"](), run["torch"](),
         F32_TWIN_RTOL)
    chunk_times["fused_loocv_f32"] = (
        *time_pair(label, "fused_loocv_f32", run["cuda"], run["torch"],
                   buf.numel(), 4),
        *bound(*fold_cost(bs, 1, 4, **KC)), None)
    del src, buf, run

    idx_loo = Partitioner(np.arange(N)).padded_batches()[1]

    def total_cv32():
        return float(materialize_cv(cfg32, Xd32, Yd32, wd32, idx_loo))

    t_warm, _ = wall(total_cv32)
    reset_launch_counts(FD, TL, SR)
    torch.cuda.reset_peak_memory_stats()
    t_total, probe32 = wall(total_cv32)
    counts = launch_counts(FD, TL, SR)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if counts["fused_loocv_f32"] != n_chunks or any(
            v for n, v in counts.items() if n != "fused_loocv_f32"):
        raise AssertionError(f"f32 LOOCV main path launches {counts}; "
                             f"expected {n_chunks} of fused_loocv_f32")
    if not np.isfinite(probe32):
        raise AssertionError(f"f32 main-path probe is not finite: {probe32}")
    kfold_launches["fused_loocv_f32"] = counts["fused_loocv_f32"]
    mat_totals[(np.float32, N)] = t_total
    bench_ref[np.float32, (N, K, M, N), False] = (probe32, t_total,
                                                  "phase 10")
    t_fit, st32 = wall(lambda: fit(cfg32, Xd32, Yd32, wd32, copy=False))
    sweeps = {"torch": [], "cuda": []}
    for impl in ("torch", "cuda", "cuda", "torch"):
        sweeps[impl].append(wall(lambda: float(
            materialize_sweep(cfg32, st32, idx_loo, impl=impl)))[0])
    gb = N * K * (K + M) * 4 / 1e9
    floor_s = gb * 1e9 / 3.35e12
    log(f"[main-f32] weighted TTTT f32 N={N} K={K} M={M} P={N} (LOOCV), "
        f"{n_chunks} chunks of {bs}  [{card}]")
    log(f"[main-f32] materialize_cv: warm-up {t_warm:.4f} s, timed total "
        f"{t_total:.4f} s -> {N / t_total:,.0f} folds/s; probe {probe32!r}; "
        f"fused_loocv_f32 launches {counts['fused_loocv_f32']}; {gb:.2f} GB "
        f"written, write floor {floor_s:.4f} s = {floor_s / t_total:.1%} of "
        f"the total; peak device memory {peak_gb:.2f} GB")
    log(f"[main-f32] fit alone {t_fit:.4f} s; fold sweep alone: kernel "
        f"{sweeps['cuda']} s, plain twin {sweeps['torch']} s (plain, kernel, "
        f"kernel, plain)")

    naive32 = NaiveOracle(True, True, True, True, ddof=1).fit(
        *(a.astype(np.float64) for a in (X32, Y32, w32)))

    def oracle32(rows_out):
        (xtx, xty), _ = naive32.training_XTX_XTY(np.delete(all_rows, rows_out))
        return np.concatenate([xtx, xty], axis=1)

    def near_oracle32(label, probe, got, ref):
        """A sweep's probe and its probe fold's full matrices against the
        float64 oracle, at 1e-3 of the oracle's largest entry."""
        scale = np.abs(ref).max()
        expect = float(ref[0, 0] + ref[0, K])
        err = np.abs(got - ref).max()
        if not (abs(probe - expect) <= F32_ORACLE_RTOL * scale
                and err <= F32_ORACLE_RTOL * scale):
            raise AssertionError(
                f"{label}: probe {probe!r} vs oracle {expect!r}, max|port - "
                f"oracle| {err:.3e}; bound {F32_ORACLE_RTOL:g} * {scale:.3e}")
        log(f"[oracle-f32] {label}: probe {probe!r} vs oracle {expect!r}; "
            f"max|port - oracle| {err:.3e} = {err / scale:.3e} of "
            f"max|oracle| {scale:.3e}")

    # the probe fold, then the first and the last fold
    folds3 = np.array([f_probe, 0, N - 1])
    src = prepare_loocv_sources(cfg32, st32, folds3)
    got = loocv_from_sources(cfg32, src, folds3, return_XTY=True,
                             impl="cuda").cpu().numpy()
    for fold, got_f, probe in zip(folds3, got, (
            probe32, *(float(g[0, 0] + g[0, K]) for g in got[1:]))):
        near_oracle32(f"LOOCV fold {fold}", probe, got_f, oracle32(fold))
    del src

    # ---- 11. float32 K-fold at full width ------------------------------------
    total32 = torch.cat([st32.XTX, st32.XTY], dim=1)
    log(f"[kfold-f32] weighted TTTT f32 N={N} K={K} M={M}, "
        f"Partitioner(np.arange(N) % P)  [{card}]")
    for p, expect in KFOLD_P32:
        idx, mask, bs_p, n_chunks_p = chunk_idx(p)
        masked = "" if mask is None else ", masked"
        label = f"f32 P={p:,} chunk of {bs_p} folds x L={idx.shape[1]}{masked}"
        rows, mask_d = TB._rows_mask(cfg32, st32, idx[:bs_p],
                                     None if mask is None else mask[:bs_p])
        buf = torch.empty((bs_p, K, K + M), dtype=torch.float32, device=dev)
        if expect == "fold_packed_f32":
            ops, _ = TB.prepare_fold_operands(cfg32, st32, rows, mask_d)
            run = {impl: (lambda impl=impl: TB.downdate_from_operands(
                ops, impl=impl, out=buf if impl == "cuda" else None))
                for impl in ("cuda", "torch")}
        else:
            blocks, stats5 = TB._gather_and_stats(cfg32, st32, rows, mask_d,
                                                  True, True)
            kvec, cvec = TB._reference_vectors(
                cfg32, st32, stats5, st32.X.new_empty((bs_p, 0)), True, True)
            m2 = torch.cat([blocks.Xv_u, blocks.Yv_u], dim=2)
            run = {impl: (lambda impl=impl: FD.fold_downdate_f32(
                total32, blocks.Xv_w, m2, kvec, cvec, impl=impl,
                out=buf if impl == "cuda" else None))
                for impl in ("cuda", "torch")}
            splits = FD.downdate_f32_splits(bs_p, K, K + M, idx.shape[1],
                                            n_sm)
            label += f", {splits} split(s)"
        hold(label, expect, run["cuda"](), run["torch"](), F32_TWIN_RTOL)
        cost = fold_cost(bs_p, idx.shape[1], 4, gathered=False, **KC)
        chunk_bound = bound(*cost)
        if expect == "fold_packed_f32":
            ms = store_chunk(label + ", packed float32", {
                "plain": run["torch"], "kernel": run["cuda"],
                "torch.bmm": lambda: torch.bmm(ops.u.mT, ops.v)}, buf, cost)
            pair, lib = (ms["kernel"], ms["plain"]), ms["torch.bmm"]
        else:
            pair = time_pair(label, expect, run["cuda"], run["torch"],
                             buf.numel(), 4,
                             flops=product_flops(bs_p, idx.shape[1]))
            lib = library_ms(blocks.Xv_w, m2)
            log(f"[kfold-chunk] {label}: torch.bmm of the blocks {lib:.4f} "
                f"ms; bound {chunk_bound[0]:.4f} ms ({chunk_bound[1]})  "
                f"[{card}]")
        if p != 3:  # the kernels line times the unmasked route's chunk
            chunk_times[expect] = (*pair, *chunk_bound, lib)
        run = buf = ops = blocks = m2 = None

        def cv32(idx=idx, mask=mask):
            return float(materialize_cv(cfg32, Xd32, Yd32, wd32, idx, mask))

        t_warm, _ = wall(cv32)
        reset_launch_counts(FD, TL, SR)
        torch.cuda.reset_peak_memory_stats()
        t_total, probe = wall(cv32)
        counts = launch_counts(FD, TL, SR)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if counts[expect] != n_chunks_p or any(
                v for n, v in counts.items() if n != expect):
            raise AssertionError(f"f32 P={p}: launches {counts}; expected "
                                 f"{n_chunks_p} of {expect}")
        if not np.isfinite(probe):
            raise AssertionError(f"f32 P={p}: probe is not finite: {probe}")
        kfold_launches[expect] = kfold_launches.get(expect, 0) + counts[expect]
        sweeps = {impl: wall(lambda impl=impl: float(materialize_sweep(
            cfg32, st32, idx, mask, impl=impl)))[0]
            for impl in ("torch", "cuda")}
        gb = p * K * (K + M) * 4 / 1e9
        floor_s = gb * 1e9 / 3.35e12
        log(f"[kfold-f32] P={p:,} (L={idx.shape[1]}{masked}, {n_chunks_p} "
            f"chunks of {bs_p}): total {t_total:.4f} s (warm-up "
            f"{t_warm:.4f} s) -> {p / t_total:,.0f} folds/s; {expect} "
            f"launches {counts[expect]}; {gb:.2f} GB written, write floor "
            f"{floor_s:.4f} s = {floor_s / t_total:.1%} of the total; peak "
            f"{peak_gb:.2f} GB; sweep alone: kernel {sweeps['cuda']:.4f} s, "
            f"plain {sweeps['torch']:.4f} s; probe {probe!r}")
        f = min((n_chunks_p - 1) * bs_p, p - 1)
        rows_f = idx[f] if mask is None else idx[f][mask[f] > 0]
        got = batch(cfg32, st32, idx[f:f + 1],
                    None if mask is None else mask[f:f + 1], True, True,
                    "cuda")[0].cpu().numpy()
        near_oracle32(f"P={p:,} fold {f} ({rows_f.size} rows)", probe, got,
                      oracle32(rows_f))

    # ---- 12. TF32 ----------------------------------------------------------
    prev = torch.get_float32_matmul_precision()
    states, bare = {}, {}
    try:
        for prec in ("high", "highest"):
            torch.set_float32_matmul_precision(prec)
            states[prec] = fit(cfg32, Xd32, Yd32, wd32, copy=False)
            bare[prec] = torch.matmul(Xd32.T, Xd32)
    finally:
        torch.set_float32_matmul_precision(prev)
    fields = [n for n, v in vars(states["highest"]).items()
              if isinstance(v, torch.Tensor)]
    differ = [n for n in fields if not torch.equal(
        getattr(states["high"], n), getattr(states["highest"], n))]
    if differ:
        raise AssertionError(f"the float32 fit under 'high' differs from "
                             f"'highest' in {differ}")
    bare_diff = (bare["high"] - bare["highest"]).abs().max().item()
    log(f"[tf32] float32 fit under 'high' equals 'highest' bit for bit "
        f"({len(fields)} tensors); a bare float32 torch.matmul differs by "
        f"{bare_diff:.3e} between the two settings")

    # ---- 13. policy-routed kernels against twins ---------------------------
    default_policy = policy()
    new_kernels = ("fused_loocv_x2", "fused_loocv_f32x2", "fused_loocv_sym",
                   "fold_v3_sym")
    for name in new_kernels:  # fold_v3_sym's phase 6 edges stay counted
        fold_err.setdefault(name, 0.0)
        fold_rel.setdefault(name, 0.0)

    def only(before, name, label):
        after = launch_counts(FD, TL, SR)
        moved = {n for n in after if after[n] != before[n]}
        if moved != {name}:
            raise AssertionError(f"{label}: launched {moved}, expected "
                                 f"{name}")

    def held(name, got, ref, rtol, label):
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not err <= rtol * scale:
            raise AssertionError(f"{label}: {name} kernel vs twin max|diff| "
                                 f"{err:.3e} > {rtol:g} * {scale:.3e}")
        fold_err[name] = max(fold_err[name], err)
        fold_rel[name] = max(fold_rel[name], err / scale)

    def symmetric(out, label):
        x = out[:, :, :K]
        if not torch.equal(x, x.mT):
            raise AssertionError(f"{label}: X block not exactly symmetric")

    iu = torch.triu_indices(K, K, device=dev)
    upper_diff = {"fused_loocv_sym": 0.0, "fold_v3_sym": 0.0}

    def upper_vs_full(name, got, full):
        """max|sym - full| over the upper triangle and the XTY columns: the
        same arithmetic, so 0 is expected; logged, not held."""
        d = max((got[:, iu[0], iu[1]] - full[:, iu[0], iu[1]]).abs().max(),
                (got[:, :, K:] - full[:, :, K:]).abs().max()).item()
        upper_diff[name] = max(upper_diff[name], d)

    rng = np.random.default_rng(SEED + 3)
    rows64 = np.sort(rng.choice(n_small, 64, replace=False))
    v3_idx = np.stack([rng.choice(n_small, 100, replace=False)
                       for _ in range(8)])
    v3_mask = np.ones(v3_idx.shape)
    v3_mask[::2, -10:] = 0.0
    cases = 0
    for flags in itertools.product([True, False], repeat=4):
        for w in (ws, None):
            for dtype in (np.float64, np.float32):
                f64 = dtype == np.float64
                cfg_s = CVConfig(*flags, ddof=1, dtype=dtype)
                st_s = fit(cfg_s, Xs.astype(dtype), Ys.astype(dtype),
                           None if w is None else w.astype(dtype),
                           device=dev)
                x2name = "fused_loocv_x2" if f64 else "fused_loocv_f32x2"
                rtol = TWIN_RTOL if f64 else F32_TWIN_RTOL
                for rows in (rows64, rows64[:63]):
                    label = f"{cfg_s}, {len(rows)} folds"
                    src = prepare_loocv_sources(cfg_s, st_s, rows)
                    one = loocv_from_sources(cfg_s, src, rows,
                                             return_XTY=True, impl="cuda")
                    before = launch_counts(FD, TL, SR)
                    two = loocv_from_sources(cfg_s, src, rows,
                                             return_XTY=True,
                                             two_per_step=True, impl="cuda")
                    only(before, x2name, label)
                    ref = loocv_from_sources(cfg_s, src, rows,
                                             return_XTY=True, impl="torch")
                    held(x2name, two, ref, rtol, label)
                    if not torch.equal(one, two):
                        raise AssertionError(f"{label}: {x2name} differs "
                                             "from one fold per block")
                    cases += 1
                    if not f64:
                        continue
                    before = launch_counts(FD, TL, SR)
                    sym = loocv_from_sources(cfg_s, src, rows,
                                             return_XTY=True, sym=True,
                                             impl="cuda")
                    only(before, "fused_loocv_sym", label)
                    ref = loocv_from_sources(cfg_s, src, rows,
                                             return_XTY=True, sym=True,
                                             impl="torch")
                    held("fused_loocv_sym", sym, ref, TWIN_RTOL, label)
                    symmetric(sym, label)
                    upper_vs_full("fused_loocv_sym", sym, one)
                    cases += 1
                if not f64:
                    continue
                for mask in (None, v3_mask):
                    label = f"{cfg_s}, L=100, masked={mask is not None}"
                    vsrc = TB.prepare_ozaki_sources(cfg_s, st_s, v3_idx, mask)
                    full = TB.ozaki_v3_from_sources(cfg_s, vsrc,
                                                    return_XTY=True,
                                                    impl="cuda")
                    set_routing(sym_loocv=True)
                    try:
                        before = launch_counts(FD, TL, SR)
                        got = TB.ozaki_v3_from_sources(
                            cfg_s, vsrc, return_XTY=True, impl="cuda")
                        only(before, "fold_v3_sym", label)
                        ref = TB.ozaki_v3_from_sources(
                            cfg_s, vsrc, return_XTY=True, impl="torch")
                    finally:
                        set_routing(sym_loocv=False)
                    held("fold_v3_sym", got, ref, TWIN_RTOL, label)
                    symmetric(got, label)
                    upper_vs_full("fold_v3_sym", got, full)
                    cases += 1
    log(f"[policy-twin] {cases} cases (N={n_small}; LOOCV over 64 and 63 "
        f"folds in both dtypes, v3 L=100 unmasked and masked): worst "
        f"max|diff| { {n: fold_err[n] for n in new_kernels} }, worst "
        f"relative { {n: fold_rel[n] for n in new_kernels} }; x2 equal to "
        f"one fold per block bit for bit; sym X blocks exactly symmetric; "
        f"sym - full over the computed entries {upper_diff}")

    # Full-width chunks: x2 beside one fold per block, sym beside full.
    bs_x2 = bs + bs % 2  # the chunk a sweep takes under x2
    rows_x2 = torch.arange(bs_x2, dtype=torch.int64).pin_memory()
    for cfg_c, st_c, item, x2name in ((cfg, st, 8, "fused_loocv_x2"),
                                      (cfg32, st32, 4, "fused_loocv_f32x2")):
        src = prepare_loocv_sources(cfg_c, st_c, rows_x2)
        buf1 = torch.empty((bs_x2, K, K + M), dtype=st_c.X.dtype, device=dev)
        buf2 = torch.empty_like(buf1)
        fns = {
            "plain": lambda: loocv_from_sources(
                cfg_c, src, rows_x2, return_XTY=True, impl="torch"),
            "one per block": lambda: loocv_from_sources(
                cfg_c, src, rows_x2, return_XTY=True, impl="cuda", out=buf1),
            "x2": lambda: loocv_from_sources(
                cfg_c, src, rows_x2, return_XTY=True, two_per_step=True,
                impl="cuda", out=buf2),
        }
        ref = fns["plain"]()
        fns["one per block"]()
        fns["x2"]()
        held(x2name, buf2, ref, TWIN_RTOL if item == 8 else F32_TWIN_RTOL,
             f"{x2name} chunk")
        if not torch.equal(buf1, buf2):
            raise AssertionError(f"{x2name} chunk differs from one fold per "
                                 "block")
        ms = time_turns(
            f"{x2name}: {bs_x2}-fold LOOCV chunk, {dtype_name(item)}", fns,
            {"plain": 3, "one per block": 20, "x2": 20})
        chunk_times[x2name] = (ms["x2"], ms["plain"],
                               *bound(*fold_cost(bs_x2, 1, item, **KC)), None)
        del src, buf1, buf2, ref

    src = prepare_loocv_sources(cfg, st, rows_chunk)
    buf1 = torch.empty((bs, K, K + M), dtype=torch.float64, device=dev)
    buf2 = torch.empty_like(buf1)
    fns = {
        "plain sym": lambda: loocv_from_sources(
            cfg, src, rows_chunk, return_XTY=True, sym=True, impl="torch"),
        "full kernel": lambda: loocv_from_sources(
            cfg, src, rows_chunk, return_XTY=True, impl="cuda", out=buf1),
        "sym kernel": lambda: loocv_from_sources(
            cfg, src, rows_chunk, return_XTY=True, sym=True, impl="cuda",
            out=buf2),
    }
    ref = fns["plain sym"]()
    fns["full kernel"]()
    fns["sym kernel"]()
    held("fused_loocv_sym", buf2, ref, TWIN_RTOL, "fused_loocv_sym chunk")
    symmetric(buf2, "fused_loocv_sym chunk")
    upper_vs_full("fused_loocv_sym", buf2, buf1)
    ms = time_turns(f"fused_loocv_sym: {bs}-fold LOOCV chunk", fns,
                    {"plain sym": 3, "full kernel": 20, "sym kernel": 20})
    chunk_times["fused_loocv_sym"] = (
        ms["sym kernel"], ms["plain sym"],
        *bound(*fold_cost(bs, 1, 8, sym=True, **KC)), None)
    del src, buf1, buf2, ref

    for p in (10_000, 1_000):
        idx, _, bs_p, _ = chunk_idx(p)
        src = TB.prepare_ozaki_sources(cfg, st, idx[:bs_p])
        buf1 = torch.empty((bs_p, K, K + M), dtype=torch.float64, device=dev)
        buf2 = torch.empty_like(buf1)

        def v3(sym, impl, out=None, src=src):
            set_routing(sym_loocv=sym)
            try:
                return TB.ozaki_v3_from_sources(cfg, src, return_XTY=True,
                                                impl=impl, out=out)
            finally:
                set_routing(sym_loocv=False)

        a_blk, b_blk = gathered_blocks(st, idx[:bs_p])
        fns = {"plain sym": lambda: v3(True, "torch"),
               "full kernel": lambda: v3(False, "cuda", buf1),
               "sym kernel": lambda: v3(True, "cuda", buf2),
               # the library call: torch.bmm of the full gathered blocks
               "torch.bmm": lambda: torch.bmm(a_blk.mT, b_blk)}
        label = (f"fold_v3_sym: P={p:,} chunk of {bs_p} folds x "
                 f"L={idx.shape[1]}")
        ref = fns["plain sym"]()
        fns["full kernel"]()
        fns["sym kernel"]()
        held("fold_v3_sym", buf2, ref, TWIN_RTOL, label)
        symmetric(buf2, label)
        upper_vs_full("fold_v3_sym", buf2, buf1)
        ms = time_turns(label, fns, {"plain sym": 3, "full kernel": 10,
                                     "sym kernel": 10, "torch.bmm": 10})
        sym_bound = bound(*fold_cost(bs_p, idx.shape[1], 8, sym=True, **KC))
        log(f"[policy-chunk] {label}: sym kernel {ms['sym kernel']:.4f} ms, "
            f"full kernel {ms['full kernel']:.4f} ms, torch.bmm of the "
            f"gathered blocks {ms['torch.bmm']:.4f} ms; bound "
            f"{sym_bound[0]:.4f} ms ({sym_bound[1]})  [{card}]")
        if p == 1_000:
            chunk_times["fold_v3_sym"] = (ms["sym kernel"], ms["plain sym"],
                                          *sym_bound, ms["torch.bmm"])
        del src, buf1, buf2, ref, a_blk, b_blk

    # ---- 14. policy-routed sweeps at full width -----------------------------
    policy_launches = {name: 0 for name in new_kernels}
    log(f"[policy] weighted TTTT N={N} K={K} M={M} through materialize_cv "
        f"under set_routing  [{card}]")
    for label, knobs, dtype, p, expect in POLICY_RUNS:
        f64 = dtype == np.float64
        cfg_p = cfg if f64 else cfg32
        data = (Xd, Yd, wd) if f64 else (Xd32, Yd32, wd32)
        idx, mask, _, _ = chunk_idx(p)
        set_routing(**knobs)
        try:
            bs_p, n_chunks_p = sweep_chunking(cfg_p, p, K, K + M)

            def cv(idx=idx, mask=mask):
                return float(materialize_cv(cfg_p, *data, idx, mask))

            t_warm, _ = wall(cv)
            reset_launch_counts(FD, TL, SR)
            t_total, probe = wall(cv)
            counts = launch_counts(FD, TL, SR)
        finally:
            set_routing(**vars(default_policy))
        if counts[expect] != n_chunks_p or any(
                v for n, v in counts.items() if n != expect):
            raise AssertionError(f"{label}: launches {counts}; expected "
                                 f"{n_chunks_p} of {expect}")
        policy_launches[expect] += counts[expect]
        if knobs == dict(sym_loocv=True) and p == N:
            bench_ref[np.float64, (N, K, M, N), True] = (probe, t_total,
                                                         "phase 14")
        f = min((n_chunks_p - 1) * bs_p, p - 1)
        rows_f = idx[f]
        if f64:
            (xtx, xty), _ = naive.training_XTX_XTY(np.delete(all_rows,
                                                             rows_f))
            expect_probe = float(xtx[0, 0] + xty[0, 0])
            ok = abs(probe - expect_probe) <= ORACLE_RTOL * abs(expect_probe)
        else:
            (xtx, xty), _ = naive32.training_XTX_XTY(np.delete(all_rows,
                                                               rows_f))
            expect_probe = float(xtx[0, 0] + xty[0, 0])
            scale = max(np.abs(xtx).max(), np.abs(xty).max())
            ok = abs(probe - expect_probe) <= F32_ORACLE_RTOL * scale
        if not (np.isfinite(probe) and ok):
            raise AssertionError(f"{label}: probe {probe!r} vs oracle "
                                 f"{expect_probe!r} (fold {f})")
        # The default policy's total and this one's, in turns.
        turns = {"default": [], "knobs": []}
        for which in ("default", "knobs", "knobs", "default"):
            set_routing(**(knobs if which == "knobs" else {}))
            try:
                turns[which].append(wall(cv)[0])
            finally:
                set_routing(**vars(default_policy))
        log(f"[policy] {label} (L={idx.shape[1]}, {n_chunks_p} chunks of "
            f"{bs_p}): total {t_total:.4f} s (warm-up {t_warm:.4f} s); in "
            f"turns default policy {turns['default']} s, {knobs} "
            f"{turns['knobs']} s; {expect} launches {counts[expect]}; probe "
            f"{probe!r} vs oracle {expect_probe!r} (fold {f})")

    # ---- 15. reduce sweeps at full width ------------------------------------
    eye = torch.eye(K, dtype=torch.float64, device=dev)

    def trace_fn(mats, stats):
        return torch.trace(mats[0]) + mats[1][0, 0]

    def ridge_fn(mats, stats):
        return torch.linalg.solve(mats[0] + 1e-6 * eye, mats[1])

    reduce_runs = (
        ("LOOCV, trace", {}, N, trace_fn, "fused_loocv"),
        ("LOOCV under sym_loocv, trace", dict(sym_loocv=True), N, trace_fn,
         "fused_loocv_sym"),
        ("P=25,000 (packed loop), trace", {}, 25_000, trace_fn,
         "fold_packed"),
        ("P=1,000 (v3 loop), ridge solve", {}, 1_000, ridge_fn, "fold_v3"),
        ("P=1,000 under hoist_reduce=False, ridge solve",
         dict(hoist_reduce=False), 1_000, ridge_fn, "fold_v3"),
    )
    log(f"[reduce] weighted TTTT f64 N={N} K={K} M={M}: fit + "
        f"cross_validate_reduce (batch_size 512)  [{card}]")
    for label, knobs, p, fn, expect in reduce_runs:
        idx, mask, _, _ = chunk_idx(p)
        n_chunks_r = -(-p // 512)
        set_routing(**knobs)
        try:
            def run(idx=idx, mask=mask, fn=fn):
                st_r = fit(cfg, Xd, Yd, wd, copy=False)
                return cross_validate_reduce(cfg, st_r, idx, mask,
                                             reduce_fn=fn)

            t_warm, _ = wall(run)
            reset_launch_counts(FD, TL, SR)
            t_total, out = wall(run)
            counts = launch_counts(FD, TL, SR)
            n_stats = TL.fused_loocv.launches_stats
        finally:
            set_routing(**vars(default_policy))
        if counts[expect] != n_chunks_r or any(
                v for n, v in counts.items() if n != expect):
            raise AssertionError(f"{label}: launches {counts}; expected "
                                 f"{n_chunks_r} of {expect}")
        # the LOOCV loop's kernel stores each chunk's statistics
        want_stats = n_chunks_r if expect.startswith("fused_loocv") else 0
        if n_stats != want_stats:
            raise AssertionError(f"{label}: {n_stats} launches stored the "
                                 f"statistics, expected {want_stats}")
        if out.shape[0] != p or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{label}: {tuple(out.shape)} result, or "
                                 "not finite")
        worst = 0.0
        for f in (0, p // 2, p - 1):
            rows_f = idx[f] if mask is None else idx[f][mask[f] > 0]
            mats, stats = training_matrices(cfg, st, rows_f)
            ref = fn(mats, stats)
            err = (out[f] - ref).abs().max().item()
            scale = ref.abs().max().item()
            if fn is ridge_fn:
                cond = torch.linalg.cond(mats[0] + 1e-6 * eye).item()
                limit = 2e-10 * cond * scale
            else:
                cond, limit = None, ORACLE_RTOL * scale
            if not err <= limit:
                raise AssertionError(f"{label}: fold {f} max|sweep - per-fold "
                                     f"engine| {err:.3e} > {limit:.3e}")
            worst = max(worst, err / scale)
        base = mat_totals.get((np.float64, p))
        log(f"[reduce] {label}: total {t_total:.4f} s (warm-up {t_warm:.4f} "
            f"s), materialize_cv at this P {base:.4f} s; {expect} launches "
            f"{counts[expect]}; folds 0, {p // 2}, {p - 1} against the "
            f"per-fold engine: worst relative {worst:.3e}")
        del out

    def profiled(fn):
        """(seconds, ``key_averages()``) of one run of ``fn`` under
        ``torch.profiler`` (device activity only: with host activity on,
        host events carry device time of their own), the host clock around
        the call with the profiler's cost included. Where the profiler
        fails, its exception in place of the events. Only the profiler is
        guarded: an error of ``fn`` fails the phase."""
        try:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        except Exception as e:  # a measurement, not a check
            prof, err = None, e
        t, _ = wall(fn)
        if prof is None:
            return t, err
        try:
            prof.stop()
            return t, prof.key_averages()
        except Exception as e:  # a measurement, not a check
            return t, e

    def device_busy(label, fn):
        """Log the device time of one run of ``fn``, summed over every
        kernel and copy, against the host clock around the call."""
        t, events = profiled(fn)
        if isinstance(events, Exception):
            log(f"[profile] {label}: not measured (profiler: "
                f"{type(events).__name__}: {events})")
            return
        busy = sum(e.self_device_time_total for e in events) / 1e3
        t *= 1e3
        log(f"[profile] {label}: kernels {busy:.2f} ms of {t:.2f} ms under "
            f"torch.profiler, device idle {1 - busy / t:.1%}  [{card}]")

    idx_loo = chunk_idx(N)[0]
    device_busy("materialize_cv LOOCV", lambda: float(materialize_cv(
        cfg, Xd, Yd, wd, idx_loo)))
    device_busy("fit + cross_validate_reduce LOOCV, trace",
                lambda: cross_validate_reduce(
                    cfg, fit(cfg, Xd, Yd, wd, copy=False), idx_loo,
                    reduce_fn=trace_fn).sum().item())

    # ---- 16. small-fold LOOCV sources ------------------------------------------
    rng = np.random.default_rng(SEED + 4)
    idx4 = np.stack([rng.choice(n_small, 4, replace=False)
                     for _ in range(16)])
    mask4 = np.ones(idx4.shape)
    mask4[::2, -1] = 0.0
    idx4m = idx4.copy()
    idx4m[::2, -1] = 0  # a padded slot: index 0, mask 0
    cases = 0
    for flags in itertools.product([True, False], repeat=4):
        for w in (ws, None):
            for dtype in (np.float64, np.float32):
                f64 = dtype == np.float64
                cfg_s = CVConfig(*flags, ddof=1, dtype=dtype)
                st_s = fit(cfg_s, Xs.astype(dtype), Ys.astype(dtype),
                           None if w is None else w.astype(dtype),
                           device=dev)
                name = "fold_smallfold" if f64 else "fold_smallfold_f32"
                for with_y, (idx_c, mask) in itertools.product(
                        (True, False), ((idx4, None), (idx4m, mask4))):
                    label = (f"{cfg_s}, L=4, masked={mask is not None}, "
                             f"with_y={with_y}")
                    src = prepare_loocv_sources(cfg_s, st_s, idx_c, mask,
                                                return_XTY=with_y)
                    kw = dict(n_l=4, return_XTY=with_y,
                              has_mask=mask is not None)
                    before = launch_counts(FD, TL, SR)
                    got = TB.smallfold_from_sources(cfg_s, src, idx_c,
                                                    impl="cuda", **kw)
                    only(before, name, label)
                    ref = TB.smallfold_from_sources(cfg_s, src, idx_c,
                                                    impl="torch", **kw)
                    if got.dtype != st_s.X.dtype:
                        raise AssertionError(f"{label}: output {got.dtype}")
                    held(name, got, ref, TWIN_RTOL if f64 else F32_TWIN_RTOL,
                         label)
                    cases += 1
    log(f"[smallfold-twin] {cases} cases (N={n_small}; 16 folds of L=4, "
        f"unmasked and masked with padded slots; [XTX | XTY] and XTX; "
        f"float64 and float32): worst max|diff| "
        f"{fold_err['fold_smallfold']:.3e} / "
        f"{fold_err['fold_smallfold_f32']:.3e}, worst relative "
        f"{fold_rel['fold_smallfold']:.3e} / "
        f"{fold_rel['fold_smallfold_f32']:.3e}")

    # The first chunk of P=25,000 through the small-fold kernel, its twin
    # and the packed kernel, on the same folds.
    idx, _, bs_p, _ = chunk_idx(25_000)
    rows_c = torch.as_tensor(idx[:bs_p]).to(dev)
    # the sources' own rows, checked when they were built: the entry on
    # them syncs no more than the wrapper does
    src = prepare_loocv_sources(cfg, st, rows_c)
    ops, _ = TB.prepare_fold_operands(cfg, st, rows_c)
    buf1 = torch.empty((bs_p, K, K + M), dtype=torch.float64, device=dev)
    buf2 = torch.empty_like(buf1)
    a_blk, b_blk = gathered_blocks(st, rows_c)
    kw = dict(n_l=4, return_XTY=True, has_mask=False)
    fns = {
        "plain": lambda: TB.smallfold_from_sources(cfg, src, src.rows,
                                                   impl="torch", **kw),
        "kernel": lambda: TB.smallfold_from_sources(
            cfg, src, src.rows, impl="cuda", out=buf1, **kw),
        "packed": lambda: TB.downdate_from_operands(ops, impl="cuda",
                                                    out=buf2),
        "torch.bmm": lambda: torch.bmm(a_blk.mT, b_blk),
    }
    label = f"P=25,000 chunk of {bs_p} folds x L=4"
    ref = fns["plain"]()
    fns["kernel"]()
    fns["packed"]()
    held("fold_smallfold", buf1, ref, TWIN_RTOL, label)
    scale = ref.abs().max().item()
    d_packed = (buf2 - ref).abs().max().item()
    d_kernels = (buf1 - buf2).abs().max().item()
    if not max(d_packed, d_kernels) <= TWIN_RTOL * scale:
        raise AssertionError(f"{label}: packed vs twin {d_packed:.3e}, "
                             f"smallfold vs packed {d_kernels:.3e} > "
                             f"{TWIN_RTOL:g} * {scale:.3e}")
    cost = fold_cost(bs_p, 4, 8, **KC)
    ms = store_chunk(label + ", small-fold float64", fns, buf1, cost)
    chunk_times["fold_smallfold"] = (ms["kernel"], ms["plain"], *bound(*cost),
                                     ms["torch.bmm"])
    log(f"[smallfold-chunk] {label}: smallfold vs twin "
        f"{(buf1 - ref).abs().max().item():.3e}, packed vs twin "
        f"{d_packed:.3e}, smallfold vs packed {d_kernels:.3e} (max|twin| "
        f"{scale:.3e})  [{card}]")

    def vector_share(label, fn, reps=10):
        """The device time of the small-fold entry's two kernels over
        ``reps`` calls under ``torch.profiler``: the vector phase's share."""
        try:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        except Exception as e:  # a measurement, not a check
            log(f"[profile] {label}: not measured (profiler: "
                f"{type(e).__name__}: {e})")
            return
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        try:
            prof.stop()
            us = {n: sum(e.self_device_time_total for e in prof.key_averages()
                         if n in e.key) / reps
                  for n in ("smallfold_vectors_kernel", "rowstream_kernel")}
        except Exception as e:  # a measurement, not a check
            log(f"[profile] {label}: not measured (profiler: "
                f"{type(e).__name__}: {e})")
            return
        vec, tile = us["smallfold_vectors_kernel"], us["rowstream_kernel"]
        share = f"{vec / (vec + tile):.1%}" if vec + tile else "not measured"
        log(f"[profile] {label}: vector phase {vec / 1e3:.4f} ms, row-stream "
            f"tile {tile / 1e3:.4f} ms a call under torch.profiler; the "
            f"vector phase's share {share}  [{card}]")

    vector_share(label + ", small-fold float64", fns["kernel"])
    del src, ops, buf1, buf2, ref, fns, a_blk, b_blk

    # The same chunk through the float32 instance, on phase 10's data.
    src = prepare_loocv_sources(cfg32, st32, rows_c)
    buf1 = torch.empty((bs_p, K, K + M), dtype=torch.float32, device=dev)
    a_blk, b_blk = gathered_blocks(st32, rows_c)
    fns = {
        "plain": lambda: TB.smallfold_from_sources(cfg32, src, src.rows,
                                                   impl="torch", **kw),
        "kernel": lambda: TB.smallfold_from_sources(
            cfg32, src, src.rows, impl="cuda", out=buf1, **kw),
        "torch.bmm": lambda: torch.bmm(a_blk.mT, b_blk),
    }
    label32 = label + ", small-fold float32"
    held("fold_smallfold_f32", fns["kernel"](), fns["plain"](),
         F32_TWIN_RTOL, label32)
    store_chunk(label32, fns, buf1, fold_cost(bs_p, 4, 4, **KC))
    vector_share(label32, fns["kernel"])
    del src, buf1, a_blk, b_blk, fns

    def smallfold_cv(idx, mask):
        """The fit, then ``prepare_loocv_sources`` and
        ``smallfold_from_sources`` over every fold in ``materialize_cv``'s
        chunks (the last one short); ``materialize_cv``'s probe."""
        st_s = fit(cfg, Xd, Yd, wd, copy=False)
        bs_s, n_s = chunking(idx.shape[0], K, K + M)
        src = prepare_loocv_sources(cfg, st_s, idx, mask)
        # slices of the sources' rows, checked once when they were built
        buf = torch.empty((bs_s, K, K + M), dtype=torch.float64, device=dev)
        for c in range(n_s):
            sl = slice(c * bs_s, (c + 1) * bs_s)
            n = src.rows[sl].shape[0]
            TB.smallfold_from_sources(
                cfg, src, src.rows[sl], src.scal[sl],
                None if mask is None else src.mask[sl], n_l=idx.shape[1],
                return_XTY=True, has_mask=mask is not None, out=buf[:n])
        return float(buf[0, 0, 0] + buf[0, 0, K])

    smallfold_launches = 0
    log(f"[smallfold] weighted TTTT f64 N={N} K={K} M={M}: fit + "
        f"prepare_loocv_sources + smallfold_from_sources in materialize_cv's "
        f"chunks  [{card}]")
    for p in (25_000, 30_000):
        idx, mask, bs_p, n_chunks_p = chunk_idx(p)
        if (np.float64, p) not in mat_totals:
            wall(lambda: float(materialize_cv(cfg, Xd, Yd, wd, idx, mask)))
            mat_totals[(np.float64, p)] = wall(lambda: float(materialize_cv(
                cfg, Xd, Yd, wd, idx, mask)))[0]
        t_warm, _ = wall(lambda: smallfold_cv(idx, mask))
        reset_launch_counts(FD, TL, SR)
        torch.cuda.reset_peak_memory_stats()
        t_total, probe = wall(lambda: smallfold_cv(idx, mask))
        counts = launch_counts(FD, TL, SR)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if counts["fold_smallfold"] != n_chunks_p or any(
                v for n, v in counts.items() if n != "fold_smallfold"):
            raise AssertionError(f"smallfold P={p}: launches {counts}; "
                                 f"expected {n_chunks_p} of fold_smallfold")
        smallfold_launches += counts["fold_smallfold"]
        f = (n_chunks_p - 1) * bs_p
        rows_f = idx[f] if mask is None else idx[f][mask[f] > 0]
        (xtx, xty), _ = naive.training_XTX_XTY(np.delete(all_rows, rows_f))
        ref = np.concatenate([xtx, xty], axis=1)
        expect = float(ref[0, 0] + ref[0, K])
        if not (np.isfinite(probe)
                and abs(probe - expect) <= ORACLE_RTOL * abs(expect)):
            raise AssertionError(f"smallfold P={p}: probe {probe!r} vs "
                                 f"oracle {expect!r} (fold {f})")
        mask_f = None if mask is None else mask[f:f + 1]
        src = prepare_loocv_sources(cfg, st, idx[f:f + 1], mask_f)
        got = TB.smallfold_from_sources(
            cfg, src, idx[f:f + 1], n_l=idx.shape[1], return_XTY=True,
            has_mask=mask is not None, impl="cuda")[0].cpu().numpy()
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=ORACLE_RTOL,
                                   atol=ORACLE_RTOL * scale)
        masked = "" if mask is None else (
            f", {int((mask.sum(1) == idx.shape[1]).sum()):,} folds of "
            f"{idx.shape[1]} rows and the rest padded, masked")
        log(f"[smallfold] P={p:,} (L={idx.shape[1]}{masked}; {n_chunks_p} "
            f"chunks of {bs_p}): total {t_total:.4f} s (warm-up "
            f"{t_warm:.4f} s) against materialize_cv (packed) "
            f"{mat_totals[(np.float64, p)]:.4f} s; fold_smallfold launches "
            f"{counts['fold_smallfold']}; peak {peak_gb:.2f} GB; probe "
            f"{probe!r} vs oracle {expect!r} (fold {f}, {rows_f.size} rows); "
            f"max|kernel - oracle| {np.abs(got - ref).max():.3e} (max|oracle| "
            f"{scale:.3e})")

    # ---- 17. the mantissa slicer at full width ----------------------------
    xh = Xd.float()
    xl = (Xd - xh.double()).float()
    e = np.frexp(np.abs(X).max(axis=0).astype(np.float32))[1].astype(
        np.int64)
    h1 = np.clip(-e, -127, 127)
    pows = torch.from_numpy(np.stack([
        np.ldexp(np.float32(1.0), h1), np.ldexp(np.float32(1.0), -e - h1),
    ]).astype(np.float32)).to(dev)
    col_scale = torch.from_numpy(2.0 ** -e.astype(np.float64)).to(dev)
    scaled = (xh.double() + xl.double()) * col_scale
    sr_err = 0
    sr_recon = 0.0
    sr_ms = {}
    for row_major in (True, False):
        layout = "row-major (N, S, K)" if row_major else "slice-major (S, N, K)"
        shape = (N, 10, K) if row_major else (10, N, K)
        buf = torch.empty(shape, dtype=torch.int8, device=dev)
        kw = dict(n_slices=10, row_major=row_major, block_rows=32)
        reset_launch_counts(FD, TL, SR)
        got = SR.slice_rows(xh, xl, pows, out=buf, **kw)
        counts = launch_counts(FD, TL, SR)
        if counts["slice_rows"] != 1 or any(
                v for n, v in counts.items() if n != "slice_rows"):
            raise AssertionError(f"slice_rows {layout}: launches {counts}")
        if row_major:
            slice_launches = counts["slice_rows"]
        ref = SR.slice_rows(xh, xl, pows, impl="torch", **kw)
        torch.cuda.synchronize()
        err = (got.int() - ref.int()).abs().max().item()
        sr_err = max(sr_err, err)
        if err:
            raise AssertionError(f"slice_rows {layout}: kernel differs from "
                                 f"its twin by up to {err}")
        sl = got if not row_major else got.transpose(0, 1)
        if sl.abs().max().item() > 65:
            raise AssertionError(f"slice_rows {layout}: a slice above 65")
        recon = torch.zeros_like(scaled)
        for s_i in range(10):
            recon += sl[s_i].double() * 2.0 ** (-6 * (s_i + 1))
        d = (recon - scaled).abs().max().item()
        if not d < 2.0 ** -58:
            raise AssertionError(f"slice_rows {layout}: reconstruction off "
                                 f"by {d:.3e} >= 2^-58")
        sr_recon = max(sr_recon, d)
        del ref, recon, sl
        fns = {"plain": lambda kw=kw: SR.slice_rows(xh, xl, pows,
                                                    impl="torch", **kw),
               "kernel": lambda kw=kw, buf=buf: SR.slice_rows(
                   xh, xl, pows, out=buf, **kw)}
        if row_major:
            # One slice beside ten: the cost of the rounds. A copy of the
            # bytes the slicer moves (8 read and 10 written an element):
            # the rate this card reaches, a ceiling beside the bound.
            buf1 = torch.empty((N, 1, K), dtype=torch.int8, device=dev)
            fns["kernel, 1 slice"] = lambda: SR.slice_rows(
                xh, xl, pows, out=buf1, n_slices=1, row_major=True,
                block_rows=32)
            src, dst = (torch.empty(N * K * 9 // 8, dtype=torch.float64,
                                    device=dev) for _ in range(2))
            fns["copy_"] = lambda: dst.copy_(src)
        ms = time_turns(f"slice_rows {layout}, {N:,} x {K}, 10 slices", fns,
                        {"plain": 3, "kernel": 20, "kernel, 1 slice": 20,
                         "copy_": 20}, tag="slice_rows")
        sr_ms[row_major] = ms
        del buf, got
    del buf1, src, dst, fns
    nbytes = N * K * (8 + 10) + 2 * K * 4
    sr_bound = bound(nbytes, 12 * 10 * N * K)
    chunk_times["slice_rows"] = (sr_ms[True]["kernel"], sr_ms[True]["plain"],
                                 *sr_bound, None)
    fold_err["slice_rows"] = float(sr_err)
    log(f"[slice_rows] X as float32 pairs, {N:,} x {K}, block_rows=32, 10 "
        f"slices: kernel bit-equal to its twin in both layouts, one launch "
        f"each, reconstruction within {sr_recon:.3e} (< 2^-58 = "
        f"{2.0 ** -58:.3e}); kernel {sr_ms[True]['kernel']:.4f} / "
        f"{sr_ms[False]['kernel']:.4f} ms (row- / slice-major) against the "
        f"bound {sr_bound[0]:.4f} ms ({sr_bound[1]}: {nbytes / 1e9:.3f} GB at "
        f"3.35 TB/s), a copy of the same bytes {sr_ms[True]['copy_']:.4f} "
        f"ms (the ceiling); row-major at one slice "
        f"{sr_ms[True]['kernel, 1 slice']:.4f} ms, so an extra slice costs "
        f"{(sr_ms[True]['kernel'] - sr_ms[True]['kernel, 1 slice']) / 9:.4f} "
        f"ms  [{card}]")
    del xh, xl, scaled

    # ---- 18. the wide-K path at full width -----------------------------
    nw, kw, mw, pw = WIDEK
    rng = np.random.default_rng(SEED)  # as bench.py builds its data
    Xw = rng.random((nw, kw), dtype=np.float64)
    Yw = rng.random((nw, mw), dtype=np.float64)
    ww = rng.random(nw)
    Xwd, Ywd, wwd = (torch.from_numpy(a).to(dev) for a in (Xw, Yw, ww))
    _, idx_w, mask_w = Partitioner(np.arange(nw) % pw).padded_batches()
    bs_w, n_chunks_w = chunking(pw, kw, kw + mw)
    n_lw = idx_w.shape[1]
    log(f"[widek] weighted TTTT f64 N={nw:,} K={kw:,} M={mw} P={pw} "
        f"(L={n_lw}), {n_chunks_w} chunks of {bs_w}  [{card}]")

    def cv_w():
        return float(materialize_cv(cfg, Xwd, Ywd, wwd, idx_w, mask_w))

    t_warm, _ = wall(cv_w)
    total_calls = []  # [XTX | XTY] builds in the timed sweep
    orig_total = TB._total

    def counted_total(*a, **k):
        total_calls.append(1)
        return orig_total(*a, **k)

    TB._total = counted_total
    reset_launch_counts(FD, TL, SR)
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    t_total, probe = wall(cv_w)
    counts = launch_counts(FD, TL, SR)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    TB._total = orig_total
    if (counts["fold_epilogue"] != n_chunks_w
            or any(v for n, v in counts.items() if n != "fold_epilogue")):
        raise AssertionError(f"wide K: launches {counts}; expected "
                             f"{n_chunks_w} of fold_epilogue and no other")
    if len(total_calls) != 1:
        raise AssertionError(f"wide K: [XTX | XTY] built "
                             f"{len(total_calls)} times in one sweep")
    if not np.isfinite(probe):
        raise AssertionError(f"wide K: probe is not finite: {probe}")
    widek_launches = counts["fold_epilogue"]
    if mask_w is None:  # one fold size: the bench's one materialize_cv
        bench_ref[np.float64, WIDEK, False] = (probe, t_total, "phase 18")
    t_fit, st_w = wall(lambda: fit(cfg, Xwd, Ywd, wwd, copy=False))
    if TB.route_kernel(cfg, st_w, n_lw, True, True, False) != "epilogue":
        raise AssertionError("wide K: the folds do not take the epilogue")
    t_sweeps = [wall(lambda: float(materialize_sweep(cfg, st_w, idx_w)))[0]
                for _ in range(2)]
    log(f"[widek] materialize_cv: warm-up {t_warm:.4f} s, timed total "
        f"{t_total:.4f} s -> {pw / t_total:.3f} folds/s; fold_epilogue "
        f"launches {widek_launches}, no other kernel; [XTX | XTY] built "
        f"{len(total_calls)} time(s) in the sweep; peak device memory "
        f"{peak_gb:.2f} GB ({peak_gb - held_gb:.2f} GB above the "
        f"{held_gb:.2f} GB held before the run); fit alone {t_fit:.4f} s; "
        f"sweep alone {t_sweeps} s; probe {probe!r}")

    # The first chunk: its product, then its epilogue against the twin.
    rows_w, _ = TB._rows_mask(cfg, st_w, idx_w[:bs_w], None)
    blocks, stats5 = TB._gather_and_stats(cfg, st_w, rows_w, None, True,
                                          True)
    kvec, cvec = TB._reference_vectors(cfg, st_w, stats5,
                                       st_w.X.new_empty((bs_w, 0)), True,
                                       True)
    m2 = torch.cat([blocks.Xv_u, blocks.Yv_u], dim=2)
    prod = torch.empty((bs_w, kw, kw + mw), dtype=torch.float64, device=dev)
    with highest_precision():
        bmm_ms = cuda_ms(lambda: torch.bmm(blocks.Xv_w.mT, m2, out=prod), 3)
        torch.bmm(blocks.Xv_w.mT, m2, out=prod)
    total_w = TB._total(st_w, True, True)
    label = f"wide K chunk of {bs_w} fold x L={n_lw}, K={kw:,}, C={kw + mw:,}"
    fold_err["fold_epilogue_widek"] = fold_rel["fold_epilogue_widek"] = 0.0
    hold(label, "fold_epilogue_widek",
         FD.fold_epilogue(total_w, prod.clone(), kvec, cvec, impl="cuda"),
         FD.fold_epilogue(total_w, prod.clone(), kvec, cvec, impl="torch"))
    flops_w = 2 * bs_w * n_lw * kw * (kw + mw)
    log(f"[widek] {label}: product torch.bmm {bmm_ms:.4f} ms "
        f"({flops_w / bmm_ms / 1e9:.1f} TFLOP/s)  [{card}]")
    chunk_times["fold_epilogue_widek"] = epilogue_chunk(
        label + ", epilogue over the product", total_w, prod, kvec, cvec)
    ep_ms = chunk_times["fold_epilogue_widek"][0]
    log(f"[widek] epilogue share of the sweep: {n_chunks_w} x {ep_ms:.4f} "
        f"ms = {n_chunks_w * ep_ms / 1e3 / min(t_sweeps):.1%} of "
        f"{min(t_sweeps):.4f} s; products {n_chunks_w} x {bmm_ms:.4f} ms "
        f"= {n_chunks_w * bmm_ms / 1e3 / min(t_sweeps):.1%}")
    del prod, blocks, stats5, m2, total_w

    # The probe fold against the oracle on a column subset: centring and
    # scaling act column by column, so the full-width run's entries of
    # these columns are the oracle's on X[:, cols].
    cols = np.r_[0:128, kw - 128:kw]
    f_w = (n_chunks_w - 1) * bs_w
    rows_f = idx_w[f_w]
    (xtx_o, xty_o), _ = NaiveOracle(True, True, True, True, ddof=1).fit(
        Xw[:, cols], Yw, ww).training_XTX_XTY(np.delete(np.arange(nw),
                                                        rows_f))
    expect = float(xtx_o[0, 0] + xty_o[0, 0])
    if not abs(probe - expect) <= ORACLE_RTOL * abs(expect):
        raise AssertionError(f"wide K: probe {probe!r} vs oracle "
                             f"{expect!r} (fold {f_w})")
    (xtx_g, xty_g), _ = TB.training_matrices_batched(cfg, st_w,
                                                     idx_w[f_w:f_w + 1])
    cols_d = torch.from_numpy(cols).to(dev)
    got = torch.cat([xtx_g[0][cols_d][:, cols_d], xty_g[0][cols_d]],
                    dim=1).cpu().numpy()
    ref = np.concatenate([xtx_o, xty_o], axis=1)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=ORACLE_RTOL,
                               atol=ORACLE_RTOL * scale)
    log(f"[widek] oracle on the first and last 128 columns of X and Y, fold "
        f"{f_w} ({rows_f.size} rows): probe relative "
        f"{abs(probe - expect) / abs(expect):.3e}; max|port - oracle| "
        f"{np.abs(got - ref).max():.3e} (max|oracle| {scale:.3e})")
    del xtx_g, xty_g, st_w, Xwd, Ywd, wwd, Xw

    # ---- 19. the mesh layer ------------------------------------------------
    import torch.distributed as dist

    from cvmatrix_tpu_torch.parallel import distributed as PD
    from cvmatrix_tpu_torch.parallel import multihost as MH

    t_phase = time.perf_counter()
    mesh_launches = dict.fromkeys(MESH_KERNELS, 0)
    oracles = {(np.float64, N): naive, (np.float32, N): naive32}
    data_n = {N: (X, Y, weights)}
    data_n[MESH_N] = tuple(a[:MESH_N] for a in data_n[N])
    dev_n = {(np.float64, N): (Xd, Yd, wd), (np.float32, N): (Xd32, Yd32, wd32)}
    for dt in (np.float64, np.float32):
        dev_n[dt, MESH_N] = tuple(a[:MESH_N] for a in dev_n[dt, N])
        oracles[dt, MESH_N] = NaiveOracle(True, True, True, True, ddof=1).fit(
            *(a.astype(dt).astype(np.float64) for a in data_n[MESH_N]))
    single_states = {}

    def single(dt, n):
        """The single-device port's fit of the same rows, on the card."""
        if (dt, n) not in single_states:
            single_states[dt, n] = fit(
                CVConfig(True, True, True, True, ddof=1, dtype=dt),
                *dev_n[dt, n], copy=False)
        return single_states[dt, n]

    def mesh_ref(label, dt, p, n, batch_size=None):
        """The single-device port's result of a mesh case."""
        cfg_r = CVConfig(True, True, True, True, ddof=1, dtype=dt)
        _, idx, mask = Partitioner(np.arange(n) % p).padded_batches()
        if label.startswith("matrices"):
            (xtx, xty), _ = TB.training_matrices_batched(
                cfg_r, single(dt, n), idx, mask)
            return torch.cat([xtx[[0, -1]], xty[[0, -1]]], dim=2).cpu().numpy()
        return cross_validate_reduce(
            cfg_r, single(dt, n), idx, mask, reduce_fn=diag_fn,
            **({} if batch_size is None else dict(batch_size=batch_size))
        ).cpu().numpy()

    def mesh_check(where, res, cases, n, refs=None, batch_size=None,
                   tally=True):
        """Each case: its kernel and no other launched, the result against
        the single-device port's (or ``refs``) at 1e-10 of its largest entry
        (1e-4 in float32), one fold against the oracle (1e-10, or 1e-3 of the
        oracle's largest entry in float32). ``tally`` adds the launches to
        the mesh path's counts."""
        for label, dt, p, expect in cases:
            t, got, counts = res[label]
            if not counts[expect] or any(
                    c for name, c in counts.items() if name != expect):
                raise AssertionError(f"mesh {where} {label}: launches "
                                     f"{counts}; expected {expect} only")
            ref = (mesh_ref(label, dt, p, n, batch_size) if refs is None
                   else refs[label])
            f64 = dt == np.float64
            rtol = MESH_RTOL if f64 else F32_TWIN_RTOL
            err = np.abs(got - ref).max()
            scale = np.abs(ref).max()
            if got.shape != ref.shape or not err <= rtol * scale:
                raise AssertionError(
                    f"mesh {where} {label}: {got.shape} vs {ref.shape}, "
                    f"max|diff| {err:.3e} > {rtol:g} * {scale:.3e}")
            f = 0 if label.startswith("matrices") else p // 2
            _, idx, _ = Partitioner(np.arange(n) % p).padded_batches()
            (xtx, xty), _ = oracles[dt, n].training_XTX_XTY(
                np.delete(np.arange(n), idx[f]))
            full = np.concatenate([xtx, xty], axis=1)
            want, mine = ((full, got[0]) if label.startswith("matrices")
                          else (np.concatenate([np.diag(xtx), xty[0]]),
                                got[f]))
            o_err = np.abs(mine - want).max()
            o_scale = np.abs(full).max()
            o_tol = ORACLE_RTOL if f64 else F32_ORACLE_RTOL
            if not o_err <= o_tol * o_scale:
                raise AssertionError(
                    f"mesh {where} {label}: fold {f} against the oracle "
                    f"{o_err:.3e} > {o_tol:g} * {o_scale:.3e}")
            if tally:
                mesh_launches[expect] += counts[expect]
            log(f"[mesh] {where} {label} (N={n:,}): {t:.4f} s, {expect} "
                f"launches {counts[expect]}, no other kernel; against "
                f"{'the single-device port' if refs is None else 'one rank'}"
                f" {err / scale:.3e} relative; fold {f} against the oracle "
                f"{o_err / o_scale:.3e}")

    # (a) world size 1 on NCCL, at full width and on MESH_N rows
    MH.initialize(world_size=1, rank=0)
    try:
        mesh1 = PD.make_mesh("cuda")
        log(f"[mesh] world size 1, backend "
            f"{dist.get_backend(PD._group(mesh1))}, mesh {mesh1}  [{card}]")
        full = run_mesh(mesh1, X, Y, weights, MESH_FULL)
        mesh_check("w=1", full, MESH_FULL, N)
        small = run_mesh(mesh1, *data_n[MESH_N], MESH_SMALL)
        mesh_check("w=1", small, MESH_SMALL, MESH_N)
        for label, knobs, dt, p, expect, bs_p in MESH_POLICY:
            try:
                res = run_mesh(mesh1, *data_n[MESH_N], [(label, dt, p, expect)],
                               knobs={label: knobs}, batch_size=bs_p)
                set_routing(**knobs)
                mesh_check("w=1", res, [(label, dt, p, expect)], MESH_N,
                           batch_size=bs_p)
            finally:
                set_routing(**vars(default_policy))

        # times: the sharded sweeps beside the single-device ones, warm
        st_m = PD.fit_sharded(cfg, mesh1, X, Y, weights)
        t_fit_m = min(wall(lambda: PD.fit_sharded(cfg, mesh1, X, Y,
                                                  weights))[0]
                      for _ in range(2))
        t_fit_1 = min(wall(lambda: fit(cfg, X, Y, weights, device=dev))[0]
                      for _ in range(2))
        log(f"[mesh] fit_sharded from host arrays {t_fit_m:.4f} s, fit from "
            f"the same host arrays {t_fit_1:.4f} s (best of two)  [{card}]")
        for label, p in (("LOOCV", N), ("P=25,000", 25_000)):
            _, idx, mask = Partitioner(np.arange(N) % p).padded_batches()
            bs_m = PD._default_batch(st_m, idx.shape[1], 1, True, True, 4e9)
            runs = {
                "sharded": lambda: PD.sharded_cross_validate_reduce(
                    cfg, st_m, idx, mask, mesh=mesh1, reduce_fn=diag_fn),
                f"single, batch {bs_m}": lambda: cross_validate_reduce(
                    cfg, single(np.float64, N), idx, mask, reduce_fn=diag_fn,
                    batch_size=bs_m),
                "single, batch 512": lambda: cross_validate_reduce(
                    cfg, single(np.float64, N), idx, mask, reduce_fn=diag_fn),
            }
            times = {name: [] for name in runs}
            for name in runs:
                wall(runs[name])  # warm-up
            for name in [*runs, *reversed(runs)] * 3 + [*runs]:  # in turns
                times[name].append(wall(runs[name])[0])
            red = runs["sharded"]()
            t_gather = min(wall(lambda: PD._all_gather(mesh1, red))[0]
                           for _ in range(3))
            med = {name: float(np.median(v)) for name, v in times.items()}
            log(f"[mesh] reduce sweep {label}, weighted TTTT f64 N={N:,}, "
                "seven runs each in turns: "
                + "; ".join(f"{name} {v}" for name, v in times.items())
                + f" s; medians: sharded / single at batch {bs_m} "
                f"{med['sharded'] / med[f'single, batch {bs_m}']:.3f}, / "
                f"single at 512 {med['sharded'] / med['single, batch 512']:.3f}; "
                f"the reductions' all_gather ({red.numel() * 8 / 1e9:.3f} GB) "
                f"{t_gather * 1e3:.3f} ms  [{card}]")
            del red
            if p == N:
                for name in runs:
                    device_busy(f"mesh {label}: {name}", runs[name])
        flat = torch.zeros(K * (K + M) + 2 * (K + M) + 1, dtype=torch.float64,
                           device=dev)
        t_red = min(wall(lambda: PD._all_reduce(mesh1, flat))[0]
                    for _ in range(5))
        log(f"[mesh] world-size-1 NCCL all_reduce of the fit's "
            f"{flat.numel() * 8 / 1e6:.2f} MB {t_red * 1e3:.3f} ms  [{card}]")
        del st_m, full, flat
    finally:
        dist.destroy_process_group()

    # (b) two ranks on the one card over gloo, held against (a)'s results
    with tempfile.TemporaryDirectory() as tmp, socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        out_path = os.path.join(tmp, "rank0.npz")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank",
             str(r), "2", str(port), out_path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=600)[0])
        finally:
            for proc in procs:
                proc.kill()
                proc.wait()
        t_two = time.perf_counter() - t0
        for r, (proc, text) in enumerate(zip(procs, logs)):
            for line in text.splitlines()[-12:]:
                log(f"[mesh] two ranks, rank {r}: {line}")
            if proc.returncode:
                raise AssertionError(f"two-rank mesh run: rank {r} exited "
                                     f"{proc.returncode}")
        with np.load(out_path) as two:
            res2 = {label: (float(two[label + "/t"]), two[label],
                            json.loads(str(two[label + "/counts"])))
                    for label, *_ in MESH_SMALL}
    mesh_check("w=2 gloo", res2, MESH_SMALL, MESH_N,
               refs={label: small[label][1] for label, *_ in MESH_SMALL},
               tally=False)
    if not all(mesh_launches.values()):
        raise AssertionError(f"mesh phase: kernels never launched: "
                             f"{[n for n, c in mesh_launches.items() if not c]}")
    log(f"[mesh] launches on the mesh path (world size 1): {mesh_launches}; "
        f"two ranks over gloo in {t_two:.1f} s, processes and start included; "
        f"phase 19 in {time.perf_counter() - t_phase:.1f} s")

    # ---- 20. the reference grid at full width -------------------------------
    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    grid_csv = os.path.join(out_dir, "grid_h100.csv")
    store_bw = G.measure_write_bw(dev)
    log(f"[grid] pure store, fill_ of 1 GB: {store_bw:.1f} GB/s  [{card}]")
    grid_kernel = {np.float64: {"loocv": "fused_loocv", **ROUTE_WRAPPER},
                   np.float32: ROUTE_WRAPPER_F32}
    grid_data = {np.float64: ((Xd, Yd, wd), (X, Y, weights)),
                 np.float32: ((Xd32, Yd32, wd32), (X32, Y32, w32))}
    grid_launches: dict = {}
    oracle_rows = chunk_folds = 0
    for dt, flags, use_w, p, mode in GRID_ROWS:
        (Xg, Yg, wg), (Xh, Yh, wh) = grid_data[dt]
        wg, wh = (wg, wh) if use_w else (None, None)
        f64 = dt == np.float64
        cfg_g = CVConfig(*flags, ddof=1, dtype=dt)
        resident = torch.cuda.memory_allocated(dev)
        row = G.run_row(flags, p, Xg, Yg, wg, None, mode, dev)
        line = G.record_row(grid_csv, row, mode=mode, flags=flags, P=p,
                            use_w=use_w, N=N, K=K, M=M,
                            itemsize=np.dtype(dt).itemsize,
                            device_type="cuda", card=card,
                            store_roof=store_bw)
        # the route's kernel once a chunk and no other (none in nojit)
        st_g = fit(cfg_g, Xg, Yg, wg, copy=False)
        stacks = G.fold_buckets(N, p)
        routes = []  # (kernel, chunks) of each bucket
        for stack in stacks:
            bs_g, n_ch = sweep_chunking(cfg_g, stack.shape[0], K, K + M)
            routes.append((grid_kernel[dt][TB.route_kernel(
                cfg_g, st_g, stack.shape[1], True, True, False,
                n_folds=bs_g)], n_ch))
        want: dict = {}
        for name, n_ch in routes if mode != "nojit" else ():
            want[name] = want.get(name, 0) + n_ch
        if row.launches != want:
            raise AssertionError(f"grid {line}: launches {row.launches}, "
                                 f"expected {want}")
        for name, c in want.items():
            grid_launches[name] = grid_launches.get(name, 0) + c
        # the probe against the per-fold engine (plain torch) on its folds
        ref = scale = 0.0
        for f in G.probe_folds(cfg_g, stacks, K, M, None, mode):
            (xtx, xty), _ = training_matrices(cfg_g, st_g,
                                              torch.from_numpy(f).to(dev))
            ref += float(xtx[0, 0] + xty[0, 0])
            scale = max(scale, float(torch.cat([xtx, xty], 1).abs().max()))
        tol = ORACLE_RTOL * abs(ref) if f64 else F32_ORACLE_RTOL * scale
        err = abs(row.probe - ref)
        if not (math.isfinite(row.probe) and err <= tol):
            raise AssertionError(f"grid {line}: probe {row.probe!r} against "
                                 f"the per-fold engine {ref!r}")
        if flags == (True,) * 4 and use_w and mode == "warmjit":
            bench_ref.setdefault((dt, (N, K, M, p), False),
                                 (row.probe, row.total, "phase 20"))
        msg = ""
        if mode == "warmjit":
            # Each bucket's last chunk as the sweep runs it (padded, one
            # launch of the route's kernel), all of [XTX | XTY] against the
            # per-fold engine; its first fold is the probe's, held against
            # the oracle too at P = N and 3.
            orc = None if p not in (N, 3) else NaiveOracle(
                *flags, ddof=1).fit(*(None if a is None else
                                      a.astype(np.float64)
                                      for a in (Xh, Yh, wh)))
            chunk_probe = worst = 0.0
            sizes = []
            for stack, (name, _) in zip(stacks, routes):
                chunk = sweep_last_chunk(cfg_g, stack, K, K + M)
                sizes.append(len(chunk))
                reset_launch_counts(FD, TL, SR)
                (xtx, xty), _ = TB.training_matrices_batched(cfg_g, st_g,
                                                             chunk)
                got = torch.cat([xtx, xty], 2)
                del xtx, xty
                counts = {n: c for n, c in
                          launch_counts(FD, TL, SR).items() if c}
                n_stats = TL.fused_loocv.launches_stats
                if counts != {name: 1} or n_stats != int(
                        name.startswith("fused_loocv")):
                    raise AssertionError(f"grid {line}: chunk of {len(chunk)}"
                                         f" folds launched {counts}, "
                                         f"{n_stats} storing statistics")
                chunk_probe += float(got[0, 0, 0] + got[0, 0, K])
                for off in range(0, len(chunk), 256):
                    (exx, exy), _ = training_matrices(
                        cfg_g, st_g,
                        torch.from_numpy(chunk[off:off + 256]).to(dev))
                    ref_m = torch.cat([exx, exy], 2)
                    del exx, exy
                    diff = (got[off:off + 256] - ref_m).abs()
                    sc = float(ref_m.abs().max())
                    d = float(diff.max())
                    ok = (bool((diff <= ORACLE_RTOL * (ref_m.abs() + sc)).all())
                          if f64 else d <= F32_ORACLE_RTOL * sc)
                    if not ok:
                        raise AssertionError(
                            f"grid {line}: chunk of {len(chunk)} folds, folds "
                            f"{off}+ {d:.3e} off the per-fold engine "
                            f"(largest entry {sc:.3e})")
                    worst = max(worst, d / sc)
                    del ref_m, diff
                if orc is not None:
                    f = chunk[0]
                    (xo, yo), _ = orc.training_XTX_XTY(
                        np.delete(np.arange(N), f))
                    want_o = np.concatenate([xo, yo], axis=1)
                    g0 = got[0].double().cpu().numpy()
                    sc = np.abs(want_o).max()
                    d = np.abs(g0 - want_o).max()
                    if f64:
                        np.testing.assert_allclose(g0, want_o,
                                                   rtol=ORACLE_RTOL,
                                                   atol=ORACLE_RTOL * sc)
                    elif not d <= F32_ORACLE_RTOL * sc:
                        raise AssertionError(f"grid {line}: fold of {f.size}"
                                             f" rows {d:.3e} off the oracle")
                    oracle_rows += 1
                    msg += (f"; fold of {f.size} rows against the oracle "
                            f"{d:.3e} (max|oracle| {sc:.3e})")
                del got
            if not abs(chunk_probe - row.probe) <= tol:
                raise AssertionError(f"grid {line}: the checked chunks' probe "
                                     f"{chunk_probe!r}, the sweep's "
                                     f"{row.probe!r}")
            chunk_folds += sum(sizes)
            msg = (f"; last chunks of {sizes} folds against the per-fold "
                   f"engine {worst:.3e} of the largest entry{msg}")
        peak = "" if row.peak_bytes is None else (
            f"; {(row.peak_bytes - resident) / 1e9:.2f} GB above the "
            f"{resident / 1e9:.2f} GB resident")
        log(f"[grid] {dtype_name(np.dtype(dt).itemsize)} {line}; probe "
            f"against the per-fold engine {err:.3e}{msg}{peak}")
        del st_g
    # P=3 as the grid runs it (two fold sizes, one sweep each, unmasked)
    # beside phase 7's one masked batch: host clock, best of three, and the
    # device time by kernel under torch.profiler
    st_3 = fit(cfg, Xd, Yd, wd, copy=False)
    _, idx3, mask3 = Partitioner(np.arange(N) % 3).padded_batches()
    runs3 = {"two fold sizes, unmasked":
             lambda: [materialize_sweep(cfg, st_3, s)
                      for s in G.fold_buckets(N, 3)],
             "one masked batch": lambda: materialize_sweep(cfg, st_3, idx3,
                                                           mask3)}
    for label, fn in runs3.items():
        wall(fn)
        t3 = min(wall(fn)[0] for _ in range(3))
        _, events = profiled(fn)
        if isinstance(events, Exception):
            by_kernel = (f"not measured (profiler: {type(events).__name__}: "
                         f"{events})")
        else:
            top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
            by_kernel = "; ".join(
                f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.3f}"
                f" ms" for e in top)
        log(f"[grid-profile] P=3 weighted TTTT float64 sweep, {label}: "
            f"{t3 * 1e3:.2f} ms (best of 3); device time by kernel: "
            f"{by_kernel}  [{card}]")
    del st_3
    missing = [n for n in GRID_KERNELS if not grid_launches.get(n)]
    if missing:
        raise AssertionError(f"grid phase: kernels never launched: {missing}")
    log(f"[grid] {len(GRID_ROWS)} rows -> {grid_csv}; {chunk_folds} folds "
        f"of the rows' last chunks against the per-fold engine; "
        f"{oracle_rows} probe folds against the oracle; launches {grid_launches}; phase 20 in "
        f"{time.perf_counter() - t_phase:.1f} s  [{card}]")

    # ---- 21. the wide-K and mesh-of-one scripts, the six examples ----------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()

    def script(args, env=None, timeout=600):
        """Run ``python args`` from the checkout; its log's tail, its exit
        code 0 required."""
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, *args], cwd=ROOT, text=True,
                             capture_output=True, timeout=timeout,
                             env={**os.environ, **(env or {})})
        for line in (res.stdout + res.stderr).splitlines()[-16:]:
            log(f"[scripts] {args[1]}: {line}")
        if res.returncode:
            raise AssertionError(f"{' '.join(args)} exited {res.returncode}")
        return time.perf_counter() - t0

    widek_json = os.path.join(out_dir, "widek_genomics.json")
    t_s = script(["-m", "cvmatrix_tpu_torch.benchmarks.widek_genomics",
                  "--out", widek_json])
    with open(widek_json) as fh:
        wk = json.load(fh)
    if not (wk["sweep_vs_engine_diag_abs_d"] < 1e-6
            and wk["launches"] == {"fold_epilogue": WIDEK[3]}
            and all(map(math.isfinite, wk["diag_mean"]))):
        raise AssertionError(f"widek_genomics: {wk}")
    log(f"[scripts] widek_genomics (N={wk['N']:,}, K={wk['K']:,}, "
        f"cross_validate_reduce): fit {wk['warm_fit_s']:.4f} s, sweep "
        f"{wk['warm_folds_s']:.4f} s, total {wk['total_s']:.4f} s, "
        f"{wk['folds_per_sec']:.2f} folds/s, peak {wk['peak_fit_gb']:.2f} GB "
        f"over the fits and {wk['peak_sweep_gb']:.2f} GB over the timed "
        f"sweep, "
        f"|d| {wk['sweep_vs_engine_diag_abs_d']:.3e}, launches "
        f"{wk['launches']}; {t_s:.1f} s with the process  [{wk['card']}]")
    mesh_json = os.path.join(out_dir, "mesh_one_chip.json")
    t_s = script(["-m", "cvmatrix_tpu_torch.benchmarks.mesh_one_chip",
                  "--out", mesh_json], env={"BENCH_PS": "100000,1000"})
    with open(mesh_json) as fh:
        for r in json.load(fh):
            if not r["mesh1_vs_reduce_max_abs"] <= MESH_RTOL * abs(
                    r["reduce_fold0"]):
                raise AssertionError(f"mesh_one_chip: {r}")
            log(f"[scripts] mesh_one_chip P={r['P']:,}: materialize "
                f"{r['single_chip_s']:.4f} s, reduce "
                f"{r['single_reduce_s']:.4f} s, mesh(1) {r['mesh1_s']:.4f} s;"
                f" mesh1/reduce {r['mesh1_over_single_reduce']:.3f}, "
                f"mesh1/materialize {r['mesh1_over_single']:.3f}  "
                f"[{r['card']}]")
    log(f"[scripts] mesh_one_chip in {t_s:.1f} s with the process")
    examples = {name: ["-m", f"cvmatrix_tpu_torch.examples.{name}"]
                for name in EXAMPLES}
    examples["training_matrices_mesh"] = [
        "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=1",
        "-m", "cvmatrix_tpu_torch.examples.training_matrices_mesh"]
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, *args], cwd=ROOT,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, args in examples.items()}
    outs = {}
    try:
        for name, proc in procs.items():
            outs[name] = proc.communicate(timeout=300)[0]
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
    for name, proc in procs.items():
        for line in outs[name].splitlines()[-8:]:
            log(f"[examples] {name}: {line}")
        if proc.returncode:
            raise AssertionError(f"example {name} exited {proc.returncode}")
    log(f"[examples] six examples exited 0, together in "
        f"{time.perf_counter() - t0:.1f} s; phase 21 in "
        f"{time.perf_counter() - t_phase:.1f} s")

    # ---- 22. the bench entry on the card ------------------------------------
    t_phase = time.perf_counter()

    def bench_run(label):
        """``bench_torch.py`` at ``label``'s configuration in its own
        process, every check held against the earlier phase that ran the
        same configuration on the same data; its stdout line and its result
        record."""
        _, dt, shape, knobs, kernel = next(r for r in BENCH_RUNS
                                           if r[0] == label)
        n_b, k_b, m_b, p_b = shape
        ref, earlier, phase = bench_ref[dt, shape, bool(knobs)]
        cfg_b = CVConfig(True, True, True, True, ddof=1, dtype=dt)
        want = {kernel: sum(sweep_chunking(cfg_b, s_b.shape[0], k_b,
                                           k_b + m_b)[1]
                            for s_b in G.fold_buckets(n_b, p_b))}
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("BENCH_")}
        env.update(BENCH_N=str(n_b), BENCH_K=str(k_b), BENCH_M=str(m_b),
                   BENCH_P=str(p_b), BENCH_DTYPE=np.dtype(dt).name)
        if knobs.get("sym_loocv"):
            env["CVMATRIX_TPU_SYM_LOOCV"] = "1"
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                             text=True, capture_output=True, timeout=300,
                             env=env)
        t_proc = time.perf_counter() - t0
        if res.returncode:
            for line in (res.stdout + res.stderr).splitlines()[-16:]:
                log(f"[bench] {label}: {line}")
            raise AssertionError(f"bench {label}: bench_torch.py exited "
                                 f"{res.returncode}")
        out = res.stdout.splitlines()
        if len(out) != 1:
            raise AssertionError(f"bench {label}: stdout {out}")
        line = json.loads(out[0])
        rec = json.loads(next(s_[len("result: "):]
                              for s_ in res.stderr.splitlines()
                              if s_.startswith("result: ")))
        name = (f"weighted_TTTT_P{p_b}_total_cv_folds_per_sec_n{n_b}_k{k_b}"
                f"_{np.dtype(dt).name}")  # bench.py's formula
        rel = abs(rec["probe"] - ref) / abs(ref)
        if not (line["metric"] == name and line["unit"] == "folds/s"
                and line["package"] == "cvmatrix_tpu_torch"
                and line["card"] == card and line["value"] > 0
                and abs(line["value"] - p_b / rec["total"]) <= 0.1
                and "vs_baseline" in line):
            raise AssertionError(f"bench {label}: line {line}, record {rec}")
        if rec["launches"] != want:
            raise AssertionError(f"bench {label}: launches {rec['launches']}"
                                 f" over the timed total, expected {want}")
        if not rel <= BENCH_RTOL[dt]:
            raise AssertionError(f"bench {label}: probe {rec['probe']!r}, "
                                 f"{phase} {ref!r}")
        for k_, v_ in rec["launches"].items():
            bench_launches[k_] = bench_launches.get(k_, 0) + v_
        log(f"[bench] {label}: {line['value']:,.1f} folds/s, vs_baseline "
            f"{line['vs_baseline']}; total {rec['total']:.4f} s (first call "
            f"{rec['t_first']:.4f} s, warm-up {rec['t_warmup']:.4f} s; fit "
            f"{rec['t_fit']:.4f} s, folds {rec['t_folds']:.4f} s); launches "
            f"{rec['launches']}; probe {rec['probe']!r} vs {phase} {ref!r} "
            f"({rel:.2e} relative); total in {phase} {earlier:.4f} s; peak "
            f"{rec['peak_bytes'] / 1e9:.2f} GB; {t_proc:.1f} s with the "
            f"process  [{line['card']}]")
        return rec

    bench_launches: dict = {}
    spread = {"default": [], "P=1,000": []}
    for _ in range(BENCH_SPREAD):
        for label in spread:
            spread[label].append(bench_run(label)["total"])
    for label, *_ in BENCH_RUNS:
        if label not in spread:
            bench_run(label)
    for label, totals in spread.items():
        p_b = next(r[2][3] for r in BENCH_RUNS if r[0] == label)
        vals = sorted(p_b / t for t in totals)
        log(f"[bench] {label} spread over {len(vals)} runs in turns: folds/s "
            f"{[round(v, 1) for v in vals]}, min {vals[0]:,.1f}, median "
            f"{vals[len(vals) // 2]:,.1f}, max {vals[-1]:,.1f}; totals "
            f"{[round(t, 4) for t in totals]} s  [{card}]")
    log(f"[bench] launches {bench_launches}; phase 22 in "
        f"{time.perf_counter() - t_phase:.1f} s  [{card}]")

    # ---- 23. PLS cross-validation at full width ------------------------------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg_p = CVConfig(True, True, True, True, ddof=1, dtype=np.float64)
    st_p = fit(cfg_p, Xd, Yd, wd, copy=False)
    loocv_idx = np.arange(N)[:, None]
    n_pls = -(-N // PLS_BATCH)
    pls_bs = -(-N // n_pls)  # the sweep's equalised chunk
    last = n_pls - 1
    pls_flags = dict(center_X=True, center_Y=True, scale_X=True,
                     scale_Y=True)
    held, sizes = {}, []

    def hold(mats, stats, rows):
        """The formed-matrix route's chunk consumer: keeps the first and
        last chunks as the PLS solve gets them."""
        if len(sizes) in (0, last):
            held[len(sizes)] = (mats, stats, rows)
        sizes.append(rows.X.shape[0])
        return rows.X.new_zeros(rows.X.shape[0])

    cross_validate_reduce(cfg_p, st_p, loocv_idx, chunk_fn=hold,
                          batch_size=PLS_BATCH)
    if sizes != [pls_bs] * n_pls:
        raise AssertionError(f"PLS sweep chunks {sorted(set(sizes))} x "
                             f"{len(sizes)}, expected {n_pls} of {pls_bs}")
    pls_rows = torch.arange(N, device=dev)
    chunk_rows = {0: pls_rows[:pls_bs], last: pls_rows[last * pls_bs:]}

    def pls_solve(c, impl):
        """The kernel on formed matrices (or its twin) on chunk c."""
        return TP.solve(cfg_p, *held[c], n_components=PLS_A, impl=impl)

    def pls_operator(c, impl):
        """The operator kernel (or its twin) on chunk c."""
        return TP.solve_operator(cfg_p, st_p, chunk_rows[c],
                                 n_components=PLS_A, impl=impl)

    pls_kernel, pls_err, op_err = {}, 0.0, 0.0
    for c in (0, last):
        n_c = chunk_rows[c].shape[0]
        formed, formed_twin = pls_solve(c, "cuda"), pls_solve(c, "torch")
        op, op_twin = pls_operator(c, "cuda"), pls_operator(c, "torch")
        torch.cuda.synchronize()
        formed = formed[:n_c]
        rel = {"ikpls2 vs twin": press_rel(formed, formed_twin[:n_c]),
               "ikpls2_op vs twin": press_rel(op, op_twin),
               "ikpls2_op vs ikpls2": press_rel(op, formed)}
        finite = all(bool(torch.isfinite(t).all()) for t in (formed, op))
        if not (finite and max(rel.values()) <= TWIN_RTOL):
            raise AssertionError(f"PLS kernels, chunk {c}: relative {rel} > "
                                 f"{TWIN_RTOL:g} (or not finite)")
        pls_err = max(pls_err,
                      (formed - formed_twin[:n_c]).abs().max().item())
        op_err = max(op_err, (op - op_twin).abs().max().item())
        pls_kernel[c] = op
        log(f"[pls] chunk {c} ({n_c} folds, K={K}, M={M}, A={PLS_A}): "
            f"worst fold relative {rel}")
    pls_ms = {"torch": [], "cuda": []}
    op_ms = {"torch": [], "cuda": []}
    for what, impl in (("op", "torch"), ("formed", "cuda"), ("op", "cuda"),
                       ("op", "cuda"), ("formed", "cuda"), ("op", "torch"),
                       ("formed", "torch")):
        runs = 10 if impl == "cuda" else 1
        if what == "op":
            op_ms[impl].append(cuda_ms(
                lambda impl=impl: pls_operator(0, impl), runs))
        else:
            pls_ms[impl].append(cuda_ms(
                lambda impl=impl: pls_solve(0, impl), runs))
    least = bound(*pls_cost([(pls_bs, 1)], K, M, PLS_A, 8, True))
    xtx_once = pls_bs * K * K * 8 / HBM_BYTES_PER_S * 1e3
    chunk_times["ikpls2"] = (min(pls_ms["cuda"]), min(pls_ms["torch"]),
                             *least, None)
    chunk_times["ikpls2_op"] = (min(op_ms["cuda"]), min(op_ms["torch"]),
                                *least, None)
    clusters = OP.max_active_clusters(K, M, dev)
    log(f"[pls] one {pls_bs}-fold chunk: operator kernel {op_ms['cuda']} "
        f"ms, kernel on formed matrices {pls_ms['cuda']} ms, twins "
        f"{op_ms['torch']} / {pls_ms['torch']} ms (in turns: op twin, "
        f"formed, op, op, formed, op twin, formed twin); bound "
        f"{least[0]:.4f} ms by {least[1]}; reading each fold's XTX once "
        f"{xtx_once:.3f} ms, {PLS_A} times {PLS_A * xtx_once:.3f} ms; "
        f"operator clusters the card holds {clusters} ({8 * clusters} "
        f"folds a wave)  [{card}]")
    del held

    reset_launch_counts(TL, FD, SR, OP)
    t_pls, press = wall(lambda: cross_validate_pls(
        cfg_p, st_p, loocv_idx, n_components=PLS_A, batch_size=PLS_BATCH))
    pls_launches = launch_counts(TL, FD, SR, OP)
    want = {"ikpls2_op": n_pls}
    if {k_: v for k_, v in pls_launches.items() if v} != want:
        raise AssertionError(f"cross_validate_pls launched {pls_launches}, "
                             f"expected {want}")
    if (OP.fold_components("operator"), OP.fold_components("matrices")) != (
            N * PLS_A, 0):
        raise AssertionError(f"fold-components {OP.fold_components()}, "
                             f"expected {N * PLS_A}, all by the operator")
    if tuple(press.shape) != (N, PLS_A, M):
        raise AssertionError(f"PRESS shape {tuple(press.shape)}")
    c_last = last * pls_bs
    same = {0: press_rel(press[:pls_bs], pls_kernel[0]),
            last: press_rel(press[c_last:], pls_kernel[last])}
    if not max(same.values()) <= TWIN_RTOL:
        raise AssertionError(f"cross_validate_pls vs the kernel on its own "
                             f"chunks: {same} > {TWIN_RTOL:g}")
    oracle_rel = {}
    for p in (0, N - 1):
        ref = fold_press(Xd, Yd, wd, [p], n_components=PLS_A, ddof=1,
                         **pls_flags)
        oracle_rel[p] = press_rel(press[p:p + 1], ref[None])
    torch.cuda.synchronize()
    if not max(oracle_rel.values()) <= PLS_ORACLE_RTOL:
        raise AssertionError(f"cross_validate_pls vs tests/pls_reference.py: "
                             f"{oracle_rel} > {PLS_ORACLE_RTOL:g}")
    log(f"[pls] cross_validate_pls, {N:,} folds, A={PLS_A}: {t_pls:.4f} s "
        f"({N / t_pls:,.0f} folds/s); launches {pls_launches}; "
        f"fold-components {OP.fold_components():,}; against the kernel's "
        f"own chunks {same}; folds 0 and N-1 against the reference "
        f"{oracle_rel}; phase 23 in {time.perf_counter() - t_phase:.1f} s  "
        f"[{card}]")
    del st_p, press, pls_kernel

    # ---- 24. wide-K PLS cross-validation at the cell's shape ----------------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    nw, kw, mw, pw = WIDEK
    rng = np.random.default_rng(SEED)  # phase 18's data
    Xw = rng.random((nw, kw), dtype=np.float64)
    Yw = rng.random((nw, mw), dtype=np.float64)
    ww = rng.random(nw)
    Xwd, Ywd, wwd = (torch.from_numpy(a).to(dev) for a in (Xw, Yw, ww))
    del Xw, Yw, ww
    st_q = fit(cfg_p, Xwd, Ywd, wwd, copy=False)
    idx_q = np.arange(nw).reshape(-1, pw).T.copy()  # fold p: rows p, p + P, ..
    n_q = -(-pw // PLS_WIDE_BATCH)
    n_lq = idx_q.shape[1]
    per_chunk = 2 * PLS_A + 2
    held_q = []
    cross_validate_reduce(
        cfg_p, st_q, idx_q[:PLS_WIDE_BATCH], batch_size=PLS_WIDE_BATCH,
        chunk_fn=lambda mats, stats, rows: held_q.append(
            (mats, stats, rows)) or rows.X.new_zeros(rows.X.shape[0]))
    (mats_q, stats_q, rows_q), = held_q

    def wide_solve(impl):
        """The first chunk's solve: ``ikpls2`` sends K over ``MAX_K`` to
        ``ikpls2_wide``'s kernels (or, under "torch", to the twin)."""
        return TP.solve(cfg_p, mats_q, stats_q, rows_q, n_components=PLS_A,
                        impl=impl)

    reset_launch_counts(TL, FD, SR, OP)
    wide_q, again_q = wide_solve("cuda"), wide_solve("cuda")
    torch.cuda.synchronize()
    solve_launches = launch_counts(TL, FD, SR, OP)
    twin_q = wide_solve("torch")
    torch.cuda.synchronize()
    want = {"ikpls2_wide": 2 * per_chunk}
    if {k_: v for k_, v in solve_launches.items() if v} != want:
        raise AssertionError(f"two wide solves launched {solve_launches}, "
                             f"expected {want}")
    rel_q = press_rel(wide_q, twin_q)
    if not (bool(torch.isfinite(wide_q).all())
            and torch.equal(wide_q, again_q) and rel_q <= PLS_WIDE_TWIN_RTOL):
        raise AssertionError(f"ikpls2_wide vs twin: relative {rel_q} > "
                             f"{PLS_WIDE_TWIN_RTOL:g}, or not finite, or "
                             "not the same bits twice")
    wide_err = (wide_q - twin_q).abs().max().item()
    wide_ms = {"torch": [], "cuda": []}
    for impl in ("cuda", "torch", "cuda", "torch"):
        wide_ms[impl].append(cuda_ms(lambda impl=impl: wide_solve(impl),
                                     3 if impl == "cuda" else 1))
    least_q = bound(*pls_cost([(PLS_WIDE_BATCH, n_lq)], kw, mw, PLS_A, 8,
                              True))
    reads_ms = (PLS_WIDE_BATCH * PLS_A * kw * (kw + mw) * 8
                / HBM_BYTES_PER_S * 1e3)
    best_q = min(wide_ms["cuda"])
    chunk_times["ikpls2_wide"] = (best_q, min(wide_ms["torch"]), *least_q,
                                  None)
    log(f"[pls-wide] one chunk of {PLS_WIDE_BATCH} folds (L={n_lq}, "
        f"K={kw:,}, M={mw}, A={PLS_A}): kernels {wide_ms['cuda']} ms, twin "
        f"{wide_ms['torch']} ms (in turns); {per_chunk} launches a solve, "
        f"all ikpls2_wide; against the twin relative {rel_q:.3e}, max abs "
        f"{wide_err:.3e}; bound {least_q[0]:.4f} ms by {least_q[1]}; "
        f"reading each fold's [XTX | XTY] {PLS_A} times {reads_ms:.3f} ms "
        f"({reads_ms / best_q:.1%} of the bandwidth)  [{card}]")

    # the same chunk with no fold matrix formed: the wide operator kernels
    rows_op = torch.as_tensor(idx_q[:PLS_WIDE_BATCH], device=dev)

    def wide_op_solve(impl):
        """The first chunk through ``solve_wide_operator``: the kernels of
        ``ikpls2_wide_op`` (under "torch" its twin, called directly)."""
        if impl == "torch":
            sums = (st_q.sum_X, st_q.sum_sq_X, st_q.sum_Y, st_q.sum_sq_Y,
                    st_q.sum_w, st_q.num_nonzero_w)
            return OP.ikpls2_wide_op_reference(
                st_q.XTX, st_q.XTY, st_q.X, st_q.Y, st_q.weights, sums,
                rows_op, None, n_components=PLS_A, ddof=1,
                resolution=cfg_p.resolution, **pls_flags)
        return TP.solve_wide_operator(cfg_p, st_q, rows_op, None,
                                      n_components=PLS_A, impl=impl)

    per_op = 3 * PLS_A + 2
    reset_launch_counts(TL, FD, SR, OP)
    op_q, op_again = wide_op_solve("cuda"), wide_op_solve("cuda")
    torch.cuda.synchronize()
    op_launches = launch_counts(TL, FD, SR, OP)
    op_twin = wide_op_solve("torch")
    torch.cuda.synchronize()
    if {k_: v for k_, v in op_launches.items() if v} != {
            "ikpls2_wide_op": 2 * per_op}:
        raise AssertionError(f"two wide operator solves launched "
                             f"{op_launches}, expected {2 * per_op}")
    rel_op = press_rel(op_q, op_twin)
    if not (bool(torch.isfinite(op_q).all()) and torch.equal(op_q, op_again)
            and rel_op <= TWIN_RTOL):
        raise AssertionError(f"ikpls2_wide_op vs twin: relative {rel_op} > "
                             f"{TWIN_RTOL:g}, or not finite, or not the same "
                             "bits twice")
    wop_err = (op_q - op_twin).abs().max().item()
    formed_rel = press_rel(op_q, wide_q)
    op_ms = {"torch": [], "cuda": [], "formed": []}
    for impl in ("cuda", "formed", "torch", "cuda", "formed", "torch"):
        fn = ((lambda: wide_solve("cuda")) if impl == "formed"
              else (lambda impl=impl: wide_op_solve(impl)))
        op_ms[impl].append(cuda_ms(fn, 1 if impl == "torch" else 3))
    best_op = min(op_ms["cuda"])
    tri_ms = (PLS_A * (kw * (kw + 1) / 2 + kw * 512) * 8
              / HBM_BYTES_PER_S * 1e3)
    chunk_times["ikpls2_wide_op"] = (best_op, min(op_ms["torch"]), *least_q,
                                     None)
    log(f"[pls-wide] the same chunk with no fold matrix: kernels "
        f"{op_ms['cuda']} ms, formed route's kernels {op_ms['formed']} ms, "
        f"twin {op_ms['torch']} ms (in turns); {per_op} launches a solve, all "
        f"ikpls2_wide_op; against the twin relative {rel_op:.3e}, max abs "
        f"{wop_err:.3e}; against the formed kernels {formed_rel:.3e}; reading "
        f"the total's upper triangle {PLS_A} times {tri_ms:.3f} ms "
        f"({tri_ms / best_op:.1%} of the bandwidth)  [{card}]")
    del held_q, mats_q, stats_q, rows_q, again_q, twin_q, op_again, op_twin

    torch.cuda.empty_cache()
    reset_launch_counts(TL, FD, SR, OP)
    t_q, press_q = wall(lambda: cross_validate_pls(
        cfg_p, st_q, idx_q, n_components=PLS_A, batch_size=PLS_WIDE_BATCH))
    wide_launches = launch_counts(TL, FD, SR, OP)
    if {k_: v for k_, v in wide_launches.items() if v} != {
            "ikpls2_wide_op": n_q * per_op}:
        raise AssertionError(f"cross_validate_pls launched {wide_launches}, "
                             f"expected {n_q * per_op} ikpls2_wide_op and "
                             "no other kernel")
    comps = {r: OP.fold_components(r) for r in ("wide_op", "wide",
                                                 "matrices", "operator")}
    if comps != {"wide_op": pw * PLS_A, "wide": 0, "matrices": 0,
                 "operator": 0}:
        raise AssertionError(f"fold-components {comps}, expected "
                             f"{pw * PLS_A}, all on the wide operator route")
    if tuple(press_q.shape) != (pw, PLS_A, mw):
        raise AssertionError(f"PRESS shape {tuple(press_q.shape)}")
    same_q = press_rel(press_q[:PLS_WIDE_BATCH], op_q)
    if not same_q <= TWIN_RTOL:
        raise AssertionError(f"cross_validate_pls vs the kernels on its "
                             f"first chunk: {same_q} > {TWIN_RTOL:g}")
    oracle_q = {}
    for p in (0, pw - 1):
        ref = fold_press(Xwd, Ywd, wwd, idx_q[p], n_components=PLS_A, ddof=1,
                         **pls_flags)
        oracle_q[p] = press_rel(press_q[p:p + 1], ref[None])
    torch.cuda.synchronize()
    if not max(oracle_q.values()) <= PLS_ORACLE_RTOL:
        raise AssertionError(f"wide cross_validate_pls vs "
                             f"tests/pls_reference.py: {oracle_q} > "
                             f"{PLS_ORACLE_RTOL:g}")
    log(f"[pls-wide] cross_validate_pls, N={nw:,}, K={kw:,}, {pw} folds in "
        f"{n_q} chunks of {PLS_WIDE_BATCH}, A={PLS_A}: {t_q:.4f} s "
        f"({pw / t_q:.2f} folds/s); launches {wide_launches}; "
        f"fold-components {comps}; first chunk against the kernels' own "
        f"{same_q}; folds 0 and {pw - 1} against the reference {oracle_q}; "
        f"phase 24 in {time.perf_counter() - t_phase:.1f} s  [{card}]")
    del st_q, press_q, wide_q, op_q, Xwd, Ywd, wwd

    # ---- 25. soil-spectra PLS2 at the cell's shape --------------------------
    lucas_phase(dev, card)

    # ---- 26. result ---------------------------------------------------------
    kernel_launches = {"fused_loocv": launches, **kfold_launches,
                       **policy_launches,
                       "fold_smallfold": smallfold_launches,
                       "slice_rows": slice_launches,
                       "fold_epilogue_widek": widek_launches,
                       "ikpls2": pls_launches["ikpls2"],
                       "ikpls2_op": pls_launches["ikpls2_op"],
                       "ikpls2_wide": solve_launches["ikpls2_wide"],
                       "ikpls2_wide_op": wide_launches["ikpls2_wide_op"]}
    fold_err["fused_loocv"] = worst_abs
    fold_err["ikpls2"] = pls_err
    fold_err["ikpls2_op"] = op_err
    fold_err["ikpls2_wide"] = wide_err
    fold_err["ikpls2_wide_op"] = wop_err
    names = ("fused_loocv", *ROUTE_WRAPPER.values(),
             *ROUTE_WRAPPER_F32.values(), *new_kernels, "fold_smallfold",
             "slice_rows", "fold_epilogue_widek", "ikpls2", "ikpls2_op",
             "ikpls2_wide", "ikpls2_wide_op")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": KERNEL_SOURCES[name][0],
        "replaces": KERNEL_SOURCES[name][1],
        "launches": kernel_launches[name],
        "max_abs_err": fold_err[name],
        "ms": chunk_times[name][0],
        "plain_ms": chunk_times[name][1],
        "bound_ms": chunk_times[name][2],
        "bound_by": chunk_times[name][3],
        "library_ms": chunk_times[name][4],
        "mesh_launches": mesh_launches.get(name, 0),
        "grid_launches": grid_launches.get(name, 0),
        "bench_launches": bench_launches.get(name, 0),
    } for name in names]}), flush=True)
    print(G.card_line(dev), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(*map(int, sys.argv[2:5]), sys.argv[5]))
    sys.exit(main())
