"""The partition mesh and the four collectives of the distributed layer.

The JAX package runs its distributed operator and solver under
``shard_map`` over a 1-D device mesh, one partition per device, with
``jax.lax``'s ``all_gather``, ``psum``, ``psum_scatter`` and ``ppermute``
between them.  Here a :class:`Mesh` is P partitions on ONE torch device per
process: every per-partition tensor keeps a leading partition axis
``[P_local, ...]``, and the collectives are tensor operations across that
axis.  With a process group (``torch.distributed``, world size W), rank r
holds partitions ``[r·P/W, (r+1)·P/W)`` and each collective completes the
local operation with the group call:

=========================  ==========================  ==============================
JAX collective             inside a process            across ranks
=========================  ==========================  ==============================
``all_gather``             the stacked tensor itself   ``all_gather_into_tensor``
``psum``                   a sum over the partitions   then ``all_reduce``
``psum_scatter(tiled)``    a sum, then a slice         ``reduce_scatter_tensor``, or
                                                       ``all_reduce`` and a slice on
                                                       backends without it (gloo)
``ppermute(pairs)``        a gather along partitions   ``batch_isend_irecv`` for the
                                                       pairs that cross ranks
=========================  ==========================  ==============================

A product that adds all of a process's partitions into one output has
already done the in-process sum: :func:`allreduce_sum` and
:func:`reduce_scatter_sum` are ``psum`` and ``psum_scatter`` without it.
Complex tensors travel as ``torch.view_as_real`` views.  When a group is
given, its calls run even at world size 1.
"""

from __future__ import annotations

import weakref
from typing import Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["Mesh", "all_gather", "psum", "psum_scatter", "ppermute", "reduce_scatter_route",
           "allreduce_sum", "reduce_scatter_sum"]


class Mesh:
    """``n_partitions`` partitions on ``device``, all in this process, or,
    with ``group``, spread evenly over the group's ranks: rank r holds
    partitions ``[lo, hi) = [r·P/W, (r+1)·P/W)``.

    The mesh holds its group weakly: ``torch.distributed`` owns the group
    until ``destroy_process_group``, which must then free it and stop its
    threads at once, not whenever the last operator or solver built on the
    mesh is collected (for module globals, during interpreter shutdown).  A
    mesh whose group was destroyed raises on use."""

    def __init__(self, n_partitions: int, device, group=None):
        self.n_partitions = int(n_partitions)
        self.device = torch.device(device)
        self._group = None if group is None else weakref.ref(group)
        self.world_size = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        if self.n_partitions < 1 or self.n_partitions % self.world_size:
            raise ValueError(
                f"{self.n_partitions} partitions over {self.world_size} processes: the "
                "number of partitions must be a positive multiple of the world size")
        self.n_local = self.n_partitions // self.world_size
        self.lo = self.rank * self.n_local
        self.hi = self.lo + self.n_local

    @property
    def group(self):
        """The process group, or None for a mesh inside one process."""
        if self._group is None:
            return None
        group = self._group()
        if group is None:
            raise RuntimeError("the mesh's process group was destroyed")
        return group

    @property
    def backend(self) -> Optional[str]:
        """The group's backend name (``"nccl"``, ``"gloo"``), or None."""
        return None if self.group is None else str(dist.get_backend(self.group))

    def owner(self, p: int) -> int:
        """Rank (in the group) that holds partition ``p``."""
        return p // self.n_local

    def __repr__(self) -> str:
        return (f"Mesh(n_partitions={self.n_partitions}, device={self.device}, "
                f"world_size={self.world_size}, rank={self.rank}, backend={self.backend})")


def _real(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return torch.view_as_real(x) if x.is_complex() else x


def _like(r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_complex(r) if x.is_complex() else r


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``[P_local, ...]`` per-partition slices -> ``[P, ...]``, all of them."""
    if mesh.group is None:
        return x
    xr = _real(x)
    out = torch.empty((mesh.world_size * xr.shape[0], *xr.shape[1:]), dtype=xr.dtype,
                      device=xr.device)
    dist.all_gather_into_tensor(out, xr, group=mesh.group)
    return _like(out, x)


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``[P_local, ...]`` -> the sum over all P partitions, ``[...]``."""
    return allreduce_sum(x.sum(dim=0), mesh)


def allreduce_sum(s: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The cross-rank part of :func:`psum`: ``s`` is already the sum over
    this process's partitions (a product that added every local partition
    into one output); returns the sum over all P partitions."""
    if mesh.group is None:
        return s
    sr = _real(s)
    dist.all_reduce(sr, group=mesh.group)
    return _like(sr, s)


def reduce_scatter_route(backend: Optional[str]) -> str:
    """How :func:`psum_scatter` crosses ranks on ``backend``: NCCL has
    ``reduce_scatter_tensor``; gloo (and any other backend) takes an
    ``all_reduce`` and keeps its own slice."""
    return "reduce_scatter_tensor" if backend == "nccl" else "all_reduce"


def psum_scatter(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``psum_scatter(tiled=True)`` along the rows: ``x`` ``[P_local, P·m,
    ...]`` holds each partition's full-length contribution; returns the sum
    over all partitions, cut into P tiles of m rows, the local ones:
    ``[P_local, m, ...]``."""
    return reduce_scatter_sum(x.sum(dim=0), mesh)


def reduce_scatter_sum(s: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The cross-rank part of :func:`psum_scatter`: ``s`` ``[P·m, ...]`` is
    already the sum over this process's partitions; returns the sum over all
    partitions, cut into P tiles of m rows, the local ones: ``[P_local, m,
    ...]``."""
    P, Pl = mesh.n_partitions, mesh.n_local
    m = s.shape[0] // P
    if mesh.group is None:
        return s.reshape(P, m, *s.shape[1:])
    sr = _real(s)
    if reduce_scatter_route(mesh.backend) == "reduce_scatter_tensor":
        out = torch.empty((Pl * m, *sr.shape[1:]), dtype=sr.dtype, device=sr.device)
        dist.reduce_scatter_tensor(out, sr, group=mesh.group)
    else:
        dist.all_reduce(sr, group=mesh.group)
        out = sr[mesh.lo * m : mesh.hi * m]
    return _like(out.contiguous(), s).reshape(Pl, m, *s.shape[1:])


def ppermute(x: torch.Tensor, pairs: Sequence[tuple[int, int]], mesh: Mesh) -> torch.Tensor:
    """``[P_local, ...]`` -> ``[P_local, ...]``: partition ``dst`` receives
    partition ``src``'s slice for every ``(src, dst)`` of ``pairs`` (global
    partition numbers, each source and each destination at most once);
    partitions that receive nothing get zeros, as ``jax.lax.ppermute``
    gives them."""
    lo, hi, Pl = mesh.lo, mesh.hi, mesh.n_local
    src_of = torch.full((Pl,), Pl, dtype=torch.int64)  # Pl: the zero row
    sends, recvs = [], []
    for src, dst in pairs:
        here_s, here_d = lo <= src < hi, lo <= dst < hi
        if here_s and here_d:
            src_of[dst - lo] = src - lo
        elif here_s:
            sends.append((src - lo, mesh.owner(dst)))
        elif here_d:
            recvs.append((dst - lo, mesh.owner(src)))
    xz = torch.cat([x, torch.zeros_like(x[:1])], dim=0)
    out = xz.index_select(0, src_of.to(x.device))
    if not sends and not recvs:
        return out
    # pairs that cross ranks, posted in the order of ``pairs`` on both sides
    # (messages between two ranks match in order)
    ops, bufs = [], []
    xr = _real(x)
    for i, r in sends:
        ops.append(dist.P2POp(dist.isend, xr[i].contiguous(),
                              dist.get_global_rank(mesh.group, r), mesh.group))
    for i, r in recvs:
        buf = torch.empty_like(xr[0])
        bufs.append((i, buf))
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(mesh.group, r),
                              mesh.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for i, buf in bufs:
        out[i] = _like(buf, x)
    return out
