"""Distributed operator — the row-partitioned H-matrix over a partition mesh.

Port of ``htool_tpu/parallel/distributed.py`` (the reference's MPI
distributed operator, ``distributed_operator/distributed_operator.hpp:19-61``
and ``distributed_operator/linalg/*``): partition p owns the block row of
the H-matrix for its target-cluster partition, built with
``target_partition=p`` (``distributed_operator/utility.hpp:37-61``).
Storage is the flat bucket layout with a leading partition axis, ``[P_local,
nb, ...]``, on the mesh's device (:class:`.collectives.Mesh`: every
partition of the mesh in one process, or an even share of them per rank of
a process group).  A product runs each bucket term once over the blocks of
all local partitions, the ``[P_local·nb, ...]`` view of the bucket, through
the unplanned CUDA kernels (block rows have no tiled plans, as in the
reference), which is what the JAX package's ``shard_map`` body amounts to
on one device: the local side of every block is offset into the padded
slices ``[P_local·m_loc_max, k]``, the global side stays global, and for
'T'/'C' the kernels' atomics add the local partitions into one global
output.  The collectives of :mod:`.collectives` then join the processes:

- 'N' g2g: local products, then ``all_gather`` of the outputs
  (MPI_Allgatherv, ``add_distributed_operator_vector_product_global_to_global.hpp:76``);
- 'T'/'C' g2g: local transposed products, then ``psum`` (MPI_Allreduce, :78);
- l2l: ``all_gather`` of the local slices first (``linalg/utility.hpp:11-28``),
  and for 'T'/'C' a ``psum_scatter`` back to the owners' slices.

The local partitions' sum of 'T'/'C' is already formed in the output, so
only the cross-rank part of ``psum``/``psum_scatter`` remains
(:func:`.collectives.allreduce_sum`, :func:`.collectives.reduce_scatter_sum`).

Partition sizes differ in general; slices are padded to the largest
partition (``m_loc_max``) and compacted with precomputed gather indices.
Padded blocks (zero data) point at the partition's first row on both
sides, so every window of every term stays inside its vector.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..clustering.cluster_tree import ClusterTree
from ..generator import Generator
from ..hmatrix.assembly import HMatrixBuilder
from ..hmatrix.hmatrix import DenseBucket, HMatrix, LowRankBucket
from ..hmatrix.linalg import _bucket_terms, _kernel_operands, _term_offsets, _unplanned_term
from ..utils.device import resolve_device
from .collectives import Mesh, all_gather, allreduce_sum, psum, reduce_scatter_sum

__all__ = [
    "Mesh",
    "DistributedHMatrix",
    "build_distributed_hmatrix",
    "build_distributed_from_local_hmatrices",
    "default_mesh",
]


def _mesh_device(device) -> torch.device:
    """The device for a mesh: ``device``, or the default one (the GPU, or an
    error without one); a CUDA device gets its index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh of ``n_devices`` partitions, all on ONE device of this process
    (default: the current GPU, see :mod:`..utils.device`), with no process
    group.  ``None`` means as many partitions as there are visible GPUs (at
    least one), the partition count of the JAX package's default mesh; they
    still share one card, and the call warns when other cards stay idle.
    Several cards take one process each: start one rank a card (``torchrun
    --nproc-per-node``), call ``initialize_multihost()`` and use
    ``global_mesh``."""
    dev = _mesh_device(device)
    if n_devices is None:
        n_devices = max(1, torch.cuda.device_count()) if dev.type == "cuda" else 1
        if n_devices > 1:
            warnings.warn(
                f"default_mesh puts all {n_devices} partitions on {dev}; the other "
                f"{n_devices - 1} card(s) stay idle.  Start one process a card and use "
                "global_mesh to spread the partitions over them.", stacklevel=2)
    return Mesh(n_devices, dev)


@dataclass
class DistributedHMatrix:
    """Row-partitioned H-matrix: per-partition flat buckets, partition axis
    leading.

    ``dense_buckets`` / ``lr_buckets``: :class:`DenseBucket` /
    :class:`LowRankBucket` whose tensors are ``[P_local, nb, ...]`` and
    whose host size arrays are ``[P_local, nb]``; partition ``mesh.lo + i``
    is slice ``i``, its block row, with bucket offsets in GLOBAL cluster
    numbering.  ``part_offsets`` / ``part_sizes`` cover all P partitions.
    """

    shape: tuple[int, int]  # global (M, N), cluster numbering
    n_partitions: int
    dense_buckets: list
    lr_buckets: list
    perm_t: torch.Tensor  # [M] int64, cluster -> user
    perm_s: torch.Tensor
    part_offsets: np.ndarray  # [P] host
    part_sizes: np.ndarray  # [P] host
    m_loc_max: int = 0
    mesh: Mesh = None
    symmetry: str = "N"
    UPLO: str = "N"
    info: dict = field(default_factory=dict)

    # gather map: compact [M] <- padded [P * m_loc_max]
    _compact_idx: Any = None
    # scatter map: padded [P * m_loc_max] <- compact [M + 1] (M: a zero slot)
    _pad_idx: Any = None
    # partition row offsets (host), the block rows' t_root_off
    _t_root: Any = None
    _views: list = field(default=None, repr=False, compare=False)
    # per op: the bucket terms over all local partitions (see _folded_terms)
    _folded: dict = field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        if self.mesh is None:
            raise ValueError("a DistributedHMatrix needs its mesh")
        n_local = self.mesh.n_local
        for b in self.dense_buckets + self.lr_buckets:
            lead = (b.data if isinstance(b, DenseBucket) else b.U).shape[0]
            if lead != n_local:
                raise ValueError(f"bucket holds {lead} partitions, the mesh's process "
                                 f"holds {n_local}")

    @property
    def dtype(self) -> torch.dtype:
        for b in self.dense_buckets:
            return b.data.dtype
        for b in self.lr_buckets:
            return b.U.dtype
        return torch.float32

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    # ------------------------------------------------------------------
    def _local(self, i: int) -> HMatrix:
        """Local partition i's block row as an :class:`HMatrix` view (cached):
        bucket offsets are GLOBAL; ``t_root_off`` is the partition's row
        offset, which localizes the 't' side of stored terms and the 's' side
        of mirror terms (see ``linalg._bucket_terms``)."""
        if self._views is None:
            views = []
            for j in range(self.mesh.n_local):
                dense = [DenseBucket(b.data[j], b.t_off[j], b.s_off[j], b.t_sizes[j],
                                     b.s_sizes[j], b.mirror) for b in self.dense_buckets]
                lr = [LowRankBucket(b.U[j], b.V[j], b.t_off[j], b.s_off[j], b.t_sizes[j],
                                    b.s_sizes[j], b.ranks[j], b.mirror) for b in self.lr_buckets]
                views.append(HMatrix(
                    shape=(self.m_loc_max, self.shape[1]), dense_buckets=dense, lr_buckets=lr,
                    perm_t=self.perm_t, perm_s=self.perm_s, symmetry=self.symmetry,
                    UPLO=self.UPLO, t_root_off=int(self._t_root[self.mesh.lo + j])))
            self._views = views
        return self._views[i]

    # ------------------------------------------------------------------
    def matvec(self, x, op: str = "N"):
        """Global-to-global product in USER numbering: every process holds
        the global vector (``add_distributed_operator_vector_product_global_to_
        global.hpp:96-118``)."""
        x = torch.as_tensor(x, device=self.device)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        n_in = self.shape[1] if op == "N" else self.shape[0]
        if x.shape[0] != n_in:
            raise ValueError(
                f"input has {x.shape[0]} rows, operator expects {n_in} (op={op!r})"
            )
        in_perm = self.perm_s if op == "N" else self.perm_t
        out_perm = self.perm_t if op == "N" else self.perm_s
        yc = self._g2g(x[in_perm], op)
        y = torch.zeros_like(yc)
        y[out_perm] = yc
        return y[:, 0] if squeeze else y

    def __matmul__(self, x):
        return self.matvec(x)

    def matvec_local(self, x_loc, op: str = "N"):
        """Local-to-local product in CLUSTER numbering: the process holds only
        its partitions' padded slices (``add_distributed_operator_vector_
        product_local_to_local.hpp:18-124``).

        ``x_loc``: ``[P_local·m_loc_max, k]`` (or ``[P_local·m_loc_max]``),
        the layout of :meth:`to_local_layout`.  Returns the same layout.
        Requires a square operator with identical target/source partitions
        (the reference's l2l use case)."""
        if self.shape[0] != self.shape[1]:
            raise ValueError("local-to-local products require a square operator")
        x_loc = torch.as_tensor(x_loc, device=self.device)
        squeeze = x_loc.ndim == 1
        if squeeze:
            x_loc = x_loc[:, None]
        n_loc = self.mesh.n_local * self.m_loc_max
        if x_loc.shape[0] != n_loc:
            raise ValueError(
                f"x_loc has {x_loc.shape[0]} rows, expected P_local*m_loc_max = {n_loc}"
            )
        y = self._l2l(x_loc, op)
        return y[:, 0] if squeeze else y

    # --- layout converters (cluster numbering <-> padded local slices) ---
    def to_local_layout(self, xc):
        """``[N, ...]`` cluster-numbered -> ``[P_local·m_loc_max, ...]``, the
        padded slices of this process's partitions."""
        xc = torch.as_tensor(xc, device=self.device)
        m = self.m_loc_max
        pad = torch.zeros((1,) + tuple(xc.shape[1:]), dtype=xc.dtype, device=xc.device)
        return torch.cat([xc, pad])[self._pad_idx[self.mesh.lo * m : self.mesh.hi * m]]

    def to_global_layout(self, x_pad):
        """``[P_local·m_loc_max, ...]`` padded slices -> ``[N, ...]``
        cluster-numbered, on every process (an ``all_gather``: every
        process of the mesh calls it)."""
        x_pad = torch.as_tensor(x_pad, device=self.device)
        rest = tuple(x_pad.shape[1:])
        x_all = all_gather(x_pad.reshape(self.mesh.n_local, self.m_loc_max, *rest), self.mesh)
        return x_all.reshape(-1, *rest)[self._compact_idx]

    def to_dense(self, user_numbering: bool = True) -> np.ndarray:
        """Oracle export: the partitions' local dense blocks placed at their
        global rows (summed over the processes of the mesh)."""
        M, N = self.shape
        A = np.zeros((M, N), torch.empty((), dtype=self.dtype).numpy().dtype)
        for i in range(self.mesh.n_local):
            p = self.mesh.lo + i
            off, sz = int(self.part_offsets[p]), int(self.part_sizes[p])
            A[off : off + sz] += self._local(i).to_dense(user_numbering=False)[:sz]
        if self.mesh.group is not None:
            A = psum(torch.as_tensor(A, device=self.device)[None], self.mesh).cpu().numpy()
        if user_numbering:
            out = np.zeros_like(A)
            out[np.ix_(self.perm_t.cpu().numpy(), self.perm_s.cpu().numpy())] = A
            return out
        return A

    # ------------------------------------------------------------------
    def _folded_terms(self, op: str) -> list:
        """The bucket terms of ``op`` over the blocks of all local partitions
        at once, planned once per op on the host: ``(blocks, in_off, out_off,
        mode)`` with ``blocks`` the buckets' ``[P_local·nb, ...]`` views and
        int64 offsets into the product's vectors (both roots 0).  The local
        side of partition i's blocks (see ``linalg._bucket_terms``) is offset
        by ``i·m_loc_max − t_root`` into the padded slices, the global side
        stays global; padded blocks point at their partition's first row."""
        terms = self._folded.get(op)
        if terms is None:
            Pl, m = self.mesh.n_local, self.m_loc_max
            root = torch.as_tensor(self._t_root[self.mesh.lo : self.mesh.hi]
                                   - np.arange(Pl) * m, device=self.device)[:, None]
            terms = []
            for b in self.dense_buckets + self.lr_buckets:
                blocks = tuple(t.reshape(-1, *t.shape[2:])
                               for t in ((b.data,) if isinstance(b, DenseBucket) else (b.U, b.V)))
                for in_side, out_side, mode, is_mirror in _bucket_terms(b, op, self.symmetry):
                    in_off, out_off, in_root, out_root = _term_offsets(root, b, in_side,
                                                                       out_side, is_mirror)
                    terms.append((blocks, (in_off - in_root).reshape(-1).contiguous(),
                                  (out_off - out_root).reshape(-1).contiguous(), mode))
            self._folded[op] = terms
        return terms

    def _product(self, x, op: str):
        """op(this process's block rows) @ x, one kernel launch per bucket
        term: 'N' takes the global ``[N, k]`` (cluster numbering) and returns
        the padded slices ``[P_local·m_loc_max, k]``; 'T'/'C' take the slices
        and return the global ``[N, k]``, summed over the local partitions."""
        k = x.shape[1]
        terms = self._folded_terms(op)
        # pad rows: the widest block, so that every window stays in range
        pad_in = max((max(t.shape[1:]) for blocks, *_ in terms for t in blocks), default=1)
        out_len = self.mesh.n_local * self.m_loc_max if op == "N" else self.shape[1]
        x_pad = torch.cat([x, torch.zeros((pad_in, k), dtype=x.dtype, device=x.device)])
        y_pad = torch.zeros((out_len + pad_in, k), dtype=x.dtype, device=x.device)
        kdtype, x_k, y_k = _kernel_operands(self.dtype, x_pad, y_pad)
        for blocks, in_off, out_off, mode in terms:
            _unplanned_term(blocks, in_off, out_off, 0, 0, x_k, y_k, kdtype, mode)
        return y_pad[:out_len]

    def _g2g(self, xc, op: str):
        """Cluster-numbering g2g product."""
        k = xc.shape[1]
        xc = xc.to(torch.promote_types(self.dtype, xc.dtype))
        if op == "N":
            y = self._product(xc, "N").reshape(self.mesh.n_local, self.m_loc_max, k)
            return all_gather(y, self.mesh).reshape(-1, k)[self._compact_idx]
        # 'T' / 'C': transposed products summed over the partitions
        # (the MPI_Allreduce path, ...g2g.hpp:78)
        return allreduce_sum(self._product(self.to_local_layout(xc), op), self.mesh)

    def _l2l(self, x_loc, op: str):
        """Cluster-numbering l2l product: ``all_gather`` of the local slices,
        local products, and for 'T'/'C' a ``psum_scatter`` back to the
        owners' slices (the reference's MPI_Alltoallv + axpy reduction,
        ``...local_to_local.hpp:60-87``)."""
        k = x_loc.shape[1]
        x_loc = x_loc.to(torch.promote_types(self.dtype, x_loc.dtype))
        if op == "N":
            return self._product(self.to_global_layout(x_loc), "N")
        y_glob = self._product(x_loc, op)  # [N, k]
        pad = torch.zeros((1, k), dtype=y_glob.dtype, device=y_glob.device)
        y = reduce_scatter_sum(torch.cat([y_glob, pad])[self._pad_idx], self.mesh)
        return y.reshape(self.mesh.n_local * self.m_loc_max, k)


# ----------------------------------------------------------------------
# builders
# ----------------------------------------------------------------------


def build_distributed_hmatrix(
    generator: Generator,
    tree: ClusterTree,
    mesh: Optional[Mesh] = None,
    epsilon: float = 1e-6,
    eta: float = 10.0,
    symmetry: str = "N",
    UPLO: str = "N",
    source_tree: Optional[ClusterTree] = None,
    mode: str = "full",
    **kwargs,
) -> DistributedHMatrix:
    """Build the row-partitioned operator: one partition-restricted
    H-matrix per partition of this process, stacked into partition-axis
    bucket tensors on the mesh's device (default mesh: the tree's
    partitions on the generator's device).

    ``mode="full"``: each partition owns its full block row
    (``DefaultApproximationBuilder``, distributed_operator/utility.hpp:
    37-61).  ``mode="local"``: each partition owns only its DIAGONAL block
    (``DefaultLocalApproximationBuilder``, utility.hpp:63-88) — the
    block-Jacobi operator approximation.

    With ``symmetry`` in {'S','H'}, each partition prunes the upper/lower
    triangle of ITS diagonal partition block only
    (``partition_number_for_symmetry=p``, tree_builder.hpp:95-111) and
    products add the mirrored contributions locally — the reference's
    distributed symmetric storage."""
    if mesh is None:
        mesh = default_mesh(tree.n_partitions, device=generator.device)
    if tree.n_partitions != mesh.n_partitions:
        raise ValueError(
            f"cluster tree has {tree.n_partitions} partitions but mesh has "
            f"{mesh.n_partitions} partitions"
        )
    if mode not in ("full", "local"):
        raise ValueError(f"unknown mode {mode!r}; use 'full' or 'local'")
    st = source_tree if source_tree is not None else tree

    builder = HMatrixBuilder(epsilon=epsilon, eta=eta, symmetry=symmetry, UPLO=UPLO, **kwargs)
    locals_ = []
    for p in range(mesh.lo, mesh.hi):
        builder.partition_number_for_symmetry = p if symmetry != "N" else -1
        locals_.append(builder.build(generator, tree, st, target_partition=p,
                                     source_partition=p if mode == "local" else -1))
    return build_distributed_from_local_hmatrices(
        locals_, tree, mesh, source_tree=st, symmetry=symmetry, UPLO=UPLO,
        dtype=generator.dtype,
    )


def _layout_maps(part_offsets, part_sizes, M: int, m_loc_max: int, device) -> dict:
    """The compaction index maps between cluster numbering [M] and the padded
    slices [P·m_loc_max] (index M of the padded map reads a zero slot), and
    the partitions' row offsets."""
    Pn = len(part_offsets)
    compact = np.zeros(M, np.int64)
    pad_map = np.full(Pn * m_loc_max, M, np.int64)
    for p in range(Pn):
        off, sz = int(part_offsets[p]), int(part_sizes[p])
        compact[off : off + sz] = p * m_loc_max + np.arange(sz)
        pad_map[p * m_loc_max : p * m_loc_max + sz] = off + np.arange(sz)
    return dict(_compact_idx=torch.as_tensor(compact, device=device),
                _pad_idx=torch.as_tensor(pad_map, device=device),
                _t_root=np.asarray(part_offsets, np.int64))


def _bucket_key(b):
    if isinstance(b, DenseBucket):
        return ("dense", b.block_shape, b.mirror)
    return ("lr", b.block_shape, b.rank_padded, b.mirror)


def build_distributed_from_local_hmatrices(
    locals_: list,
    tree: ClusterTree,
    mesh: Optional[Mesh] = None,
    source_tree: Optional[ClusterTree] = None,
    symmetry: str = "N",
    UPLO: str = "N",
    dtype=None,
) -> DistributedHMatrix:
    """Wire USER-BUILT per-partition local operators into a distributed
    operator — the ``CustomApproximationBuilder`` surface
    (``distributed_operator/utility.hpp:21-35``).

    ``locals_[i]`` must be an :class:`HMatrix` whose target root is
    partition ``mesh.lo + i`` of ``tree`` (bucket offsets in GLOBAL cluster
    numbering), e.g. from ``HMatrixBuilder.build(..., target_partition=p)``
    or any custom assembly with the same layout; one per partition of this
    process.  Buckets of the same key (kind, block shape, padded rank,
    mirror) are stacked over the partitions, padded with zero blocks."""
    if mesh is None:
        mesh = default_mesh(tree.n_partitions, device=locals_[0].device if locals_ else None)
    st = source_tree if source_tree is not None else tree
    if tree.n_partitions != mesh.n_partitions:
        raise ValueError(f"cluster tree has {tree.n_partitions} partitions but mesh has "
                         f"{mesh.n_partitions} partitions")
    if len(locals_) != mesh.n_local:
        raise ValueError(f"{len(locals_)} local operators for {mesh.n_local} partitions")
    if dtype is None:
        dtype = locals_[0].dtype
    dev = mesh.device

    part_offsets, part_sizes = tree.partition_offsets_sizes()
    m_loc_max = int(part_sizes.max())
    M, N = tree.n_points, st.n_points

    # ---- unify bucket keys over the partitions and stack with padding ----
    keys = sorted({_bucket_key(b) for h in locals_ for b in h.dense_buckets + h.lr_buckets},
                  key=repr)
    dense_stacked, lr_stacked = [], []
    for key in keys:
        per_part = []
        for h in locals_:
            found = [b for b in h.dense_buckets + h.lr_buckets if _bucket_key(b) == key]
            per_part.append(found[0] if found else None)
        nb_max = max(b.n_blocks if b is not None else 0 for b in per_part)
        if nb_max == 0:
            continue
        dense = key[0] == "dense"
        bm, bn = key[1]
        shapes = [(bm, bn)] if dense else [(bm, key[2]), (key[2], bn)]

        def stack_of(get, shape):
            out = torch.zeros((mesh.n_local, nb_max, *shape), dtype=dtype, device=dev)
            for i, b in enumerate(per_part):
                if b is not None:
                    out[i, : b.n_blocks] = get(b).to(dev)
            return out

        # offsets stay GLOBAL; padded blocks point at the partition's first
        # row on both sides (zero data: zero contribution, in range)
        t_off = torch.empty((mesh.n_local, nb_max), dtype=torch.int64, device=dev)
        s_off = torch.empty_like(t_off)
        t_sz = np.zeros((mesh.n_local, nb_max), np.int64)
        s_sz = np.zeros_like(t_sz)
        rk = np.zeros_like(t_sz)
        for i, b in enumerate(per_part):
            t_off[i] = s_off[i] = int(part_offsets[mesh.lo + i])
            if b is not None:
                nb = b.n_blocks
                t_off[i, :nb] = b.t_off.to(dev)
                s_off[i, :nb] = b.s_off.to(dev)
                t_sz[i, :nb] = b.t_sizes
                s_sz[i, :nb] = b.s_sizes
                if not dense:
                    rk[i, :nb] = b.ranks
        common = dict(t_off=t_off, s_off=s_off, t_sizes=t_sz, s_sizes=s_sz, mirror=key[-1])
        if dense:
            dense_stacked.append(DenseBucket(data=stack_of(lambda b: b.data, shapes[0]),
                                             **common))
        else:
            lr_stacked.append(LowRankBucket(U=stack_of(lambda b: b.U, shapes[0]),
                                            V=stack_of(lambda b: b.V, shapes[1]),
                                            ranks=rk, **common))

    d = DistributedHMatrix(
        shape=(M, N),
        n_partitions=mesh.n_partitions,
        dense_buckets=dense_stacked,
        lr_buckets=lr_stacked,
        perm_t=torch.as_tensor(np.asarray(tree.permutation, np.int64), device=dev),
        perm_s=torch.as_tensor(np.asarray(st.permutation, np.int64), device=dev),
        part_offsets=part_offsets,
        part_sizes=part_sizes,
        m_loc_max=m_loc_max,
        mesh=mesh,
        symmetry=symmetry,
        UPLO=UPLO,
        **_layout_maps(part_offsets, part_sizes, M, m_loc_max, dev),
    )
    d.info["local_infos"] = [h.info for h in locals_]
    return d
