"""Process-level plumbing of the mesh layer, PyTorch port.

Counterpart of :mod:`cvmatrix_tpu.parallel.multihost`. The compute path is
:mod:`cvmatrix_tpu_torch.parallel.distributed`; this module adds:

- :func:`initialize`: ``torch.distributed.init_process_group`` from its
  arguments or from the environment ``torchrun`` sets;
- :func:`global_mesh`: the ``rows`` mesh over every rank;
- :func:`host_row_ranges` / :func:`host_row_slice`: which dataset rows a
  rank loads (one contiguous range a rank);
- :func:`fit_sharded_multihost`: the sharded fit from each rank's own rows,
  so that no rank holds the whole dataset.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import CVConfig
from .distributed import ShardedFitState, _rank_world, fit_rank_rows, make_mesh

__all__ = [
    "initialize",
    "global_mesh",
    "host_row_ranges",
    "host_row_slice",
    "fit_sharded_multihost",
]


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device_type: str = "cuda",
) -> None:
    """Initialise the default process group; a no-op when one exists.

    ``world_size`` and ``rank`` default to ``WORLD_SIZE`` and ``RANK`` from
    the environment (``torchrun`` sets them, with ``MASTER_ADDR``,
    ``MASTER_PORT`` and ``LOCAL_RANK``), ``init_method`` to ``env://``;
    ``backend`` to NCCL for ``device_type="cuda"`` and gloo for ``"cpu"``.
    A world of one with neither ``init_method`` nor ``MASTER_ADDR`` gets an
    in-process store, so it needs no port. Without a world size and a rank
    it raises: it never falls back to one process silently, which would
    leave every rank computing on its own rows as if they were all.
    """
    if dist.is_initialized():
        return
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None or rank is None:
        raise ValueError(
            "no process group to join: pass world_size and rank (and "
            "init_method), or run under torchrun, which sets WORLD_SIZE, "
            "RANK, MASTER_ADDR and MASTER_PORT."
        )
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise ValueError("no CUDA card: torch.cuda.is_available() is "
                             "false; pass device_type='cpu' for gloo.")
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if world_size == 1 and init_method is None and "MASTER_ADDR" not in env:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        return
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def global_mesh(device_type: str = "cuda") -> DeviceMesh:
    """The 1-D ``rows`` mesh over every rank (JAX ``:84``)."""
    return make_mesh(device_type)


def host_row_ranges(n_rows: int, mesh: DeviceMesh) -> list:
    """``[(rank, start, stop)]``: the dataset rows this rank loads, one
    range (JAX ``:89``). Rank ``i`` owns rows ``[i per, (i + 1) per)`` with
    ``per = ceil(n_rows / world)``, clamped to ``n_rows`` (a rank past the
    end owns none)."""
    rank, world = _rank_world(mesh)
    per = -(-n_rows // world)
    return [(rank, min(rank * per, n_rows), min((rank + 1) * per, n_rows))]


def host_row_slice(n_rows: int, mesh: DeviceMesh) -> Tuple[int, int]:
    """``(start, stop)`` of the dataset rows this rank loads (JAX
    ``:109``); one process a device makes every layout contiguous."""
    (_, start, stop), = host_row_ranges(n_rows, mesh)
    return start, stop


def fit_sharded_multihost(
    config: CVConfig,
    mesh: DeviceMesh,
    host_X: np.ndarray,
    host_Y: Optional[np.ndarray] = None,
    host_weights: Optional[np.ndarray] = None,
    *,
    n_rows_global: Optional[int] = None,
) -> ShardedFitState:
    """Sharded fit from this rank's own rows (JAX ``:129``): the rows of
    :func:`host_row_slice`, of ``n_rows_global`` in all (required with
    more than one rank). The same code path as
    :func:`~cvmatrix_tpu_torch.parallel.distributed.fit_sharded`, which
    slices each rank's rows out of the full arrays first; negative weights
    raise on every rank or on none."""
    _, world = _rank_world(mesh)
    if n_rows_global is None:
        if world > 1:
            raise ValueError("n_rows_global is required with more than one "
                             "rank.")
        n_rows_global = np.shape(host_X)[0]
    return fit_rank_rows(config, mesh, host_X, host_Y, host_weights,
                         n_rows_global=n_rows_global)
