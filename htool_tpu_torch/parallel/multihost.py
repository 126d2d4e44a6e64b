"""Several processes — the MPI-multi-node analog.

Port of ``htool_tpu/parallel/multihost.py``.  The JAX package wires its
processes together with ``jax.distributed.initialize`` and shards over a
global device mesh; here :func:`initialize_multihost` starts a
``torch.distributed`` process group, and :func:`global_mesh` spreads the
partitions of a :class:`.collectives.Mesh` evenly over its ranks.  The
operator, its products and the distributed solver then run unchanged: each
collective completes across the group (:mod:`.collectives`).  The backend
follows the device: NCCL for CUDA, gloo for the CPU, unless one is named.
:func:`shutdown_multihost` ends the group (the MPI_Finalize analog).

One rank a card: a launcher (``torchrun``) sets ``LOCAL_RANK`` in each
process it starts, and :func:`rank_device` turns it into the rank's card,
``cuda:{LOCAL_RANK}``, which :func:`initialize_multihost` makes the current
device before the group starts.  NCCL refuses two ranks on one card, so
with NCCL a ``LOCAL_RANK`` beyond the cards raises at once; gloo ranks may
share a card (gloo moves host memory: :mod:`.collectives` stages CUDA
tensors through it).
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .collectives import Mesh
from .distributed import _mesh_device

__all__ = ["initialize_multihost", "shutdown_multihost", "global_mesh", "is_multihost",
           "rank_device"]


def rank_device(device: torch.device, backend: str, env: Mapping[str, str],
                n_cards: int) -> torch.device:
    """The device of this rank: ``device`` itself when it is the CPU or
    names its card; for a bare ``cuda``, ``cuda:{LOCAL_RANK}`` when ``env``
    (a launcher's environment) sets ``LOCAL_RANK``, else ``cuda:0`` (one
    process on its host).  NCCL takes one rank a card, so under ``backend``
    ``"nccl"`` a ``LOCAL_RANK`` at or beyond ``n_cards`` raises; gloo ranks
    beyond the cards share them (rank r takes card r mod ``n_cards``)."""
    if device.type != "cuda" or device.index is not None:
        return device
    local = env.get("LOCAL_RANK", "")
    if not local:
        return torch.device("cuda", 0)
    r = int(local)
    if r >= n_cards and backend == "nccl":
        raise RuntimeError(
            f"LOCAL_RANK={r}, but this host has {n_cards} CUDA device(s): NCCL takes one rank "
            f"a card, so start at most {n_cards} rank(s) on this host, or use the gloo backend "
            "for ranks that share a card")
    if n_cards < 1:
        raise RuntimeError(f"LOCAL_RANK={r} asks for a CUDA device, and this host has none")
    return torch.device("cuda", r % n_cards)


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
    :mod:`..utils.device`) is a CUDA device, else gloo.  A CUDA device
    without an index is the rank's card by :func:`rank_device`
    (``cuda:{LOCAL_RANK}`` under a launcher, else ``cuda:0``); it becomes
    the current device before the group starts, so :func:`global_mesh` and
    ``default_mesh`` called afterwards default to it.  A process whose group
    is already up returns at once."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if not all(os.environ.get(v) for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
            return  # single process: nothing to wire
        coordinator_address = "env://"
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        dev = rank_device(dev, backend, os.environ, torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend=backend, init_method=coordinator_address,
                            world_size=num_processes if num_processes is not None else -1,
                            rank=process_id if process_id is not None else -1)


def shutdown_multihost() -> None:
    """End the default process group that :func:`initialize_multihost`
    started: a barrier, so that no rank tears its connections down while a
    peer still sends to it, then ``destroy_process_group``, which frees the
    group and stops its threads (meshes hold their group weakly).  Without a
    group this does nothing."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":  # on this rank's card, not one NCCL guesses
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
    dist.destroy_process_group()


def is_multihost() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(n_partitions: Optional[int] = None, device=None) -> Mesh:
    """A mesh over every process of the group that :func:`initialize_multihost`
    started: ``n_partitions`` partitions (default: one per process) spread
    evenly over the ranks, on ``device`` (default: this rank's card, which
    :func:`initialize_multihost` made current; the CPU after
    ``set_default_device("cpu")``).  Build the cluster tree with
    ``n_partitions = mesh.n_partitions``."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_multihost first")
    if n_partitions is None:
        n_partitions = dist.get_world_size()
    return Mesh(n_partitions, _mesh_device(device), group=dist.group.WORLD)
