"""Several processes — the MPI-multi-node analog.

Port of ``htool_tpu/parallel/multihost.py``.  The JAX package wires its
processes together with ``jax.distributed.initialize`` and shards over a
global device mesh; here :func:`initialize_multihost` starts a
``torch.distributed`` process group, and :func:`global_mesh` spreads the
partitions of a :class:`.collectives.Mesh` evenly over its ranks.  The
operator, its products and the distributed solver then run unchanged: each
collective completes across the group (:mod:`.collectives`).  The backend
follows the device: NCCL for CUDA, gloo for the CPU, unless one is named.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .collectives import Mesh
from .distributed import _mesh_device

__all__ = ["initialize_multihost", "global_mesh", "is_multihost"]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Start the default process group (the MPI_Init analog).

    ``coordinator_address`` is ``torch.distributed``'s init method:
    ``file:///path`` (a file store, no network) or
    ``tcp://localhost:<port>``; with ``num_processes`` and ``process_id``.
    Without it, the ``env://`` variables (``MASTER_ADDR``, ``WORLD_SIZE``,
    ``RANK``) are used when set, and a single process does nothing.
    ``backend`` defaults to NCCL when ``device`` (default: the GPU, see
    :mod:`..utils.device`) is a CUDA device, else gloo.  A process whose
    group is already up returns at once."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if not all(os.environ.get(v) for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
            return  # single process: nothing to wire
        coordinator_address = "env://"
    dev = _mesh_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend=backend, init_method=coordinator_address,
                            world_size=num_processes if num_processes is not None else -1,
                            rank=process_id if process_id is not None else -1)


def is_multihost() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(n_partitions: Optional[int] = None, device=None) -> Mesh:
    """A mesh over every process of the group that :func:`initialize_multihost`
    started: ``n_partitions`` partitions (default: one per process) spread
    evenly over the ranks, on ``device`` (default: the GPU).  Build the
    cluster tree with ``n_partitions = mesh.n_partitions``."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_multihost first")
    if n_partitions is None:
        n_partitions = dist.get_world_size()
    return Mesh(n_partitions, _mesh_device(device), group=dist.group.WORLD)
