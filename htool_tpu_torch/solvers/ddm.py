"""Domain-decomposition (Schwarz) preconditioners and the DDM solver.

Port of ``htool_tpu/solvers/ddm.py`` (the reference's DDM + HPDDM stack,
``solvers/ddm.hpp:29-382``, ``solvers/utility.hpp:22-359``): subdomains are
the cluster-tree partitions plus (optional) geometric overlap; local solves
are batched dense solves with precomputed explicit inverses (the
``DDMSolverWithDenseLocalSolver`` mode, utility.hpp:195-211); the Krylov
loop is :mod:`.krylov`.

Preconditioner variants (HPDDM ``-hpddm_schwarz_method``):
- ``"none"``   : unpreconditioned Krylov
- ``"jacobi"`` : block-Jacobi, no overlap (overlap ignored in the solve)
- ``"asm"``    : Additive Schwarz, M⁻¹ = Σ Rᵢᵀ Aᵢ⁻¹ Rᵢ
- ``"ras"``    : Restricted Additive Schwarz, M⁻¹ = Σ Rᵢᵀ Dᵢ Aᵢ⁻¹ Rᵢ with
  partition of unity Dᵢ = 1 on interior / 0 on overlap (ddm.hpp:59-63)

The explicit batched inverse is kept (not LU solves) so that iteration
counts stay comparable with the reference.  ``local_solver="blr"`` and
``"blr2"`` replace the dense inverses by compressed LU factorizations of
each subdomain matrix (:class:`BLRSchwarzPreconditioner`, the reference's
``LocalHMatrixSolver``).  A GenEO coarse space (:mod:`.geneo`) passed as
``coarse=`` makes the preconditioner two-level, with the additive, deflated
or balanced correction.

CG's step replays from CUDA graphs (:class:`.krylov.CGGraphs`) where the
solver can see that nothing in it needs the host: the vectors on a CUDA
device, an :class:`~htool_tpu_torch.hmatrix.hmatrix.HMatrix` operator, and
the dense one-level Schwarz apply or no preconditioner.  Every other solve
issues the same arithmetic eagerly.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..clustering.cluster_tree import ClusterTree
from ..generator import Generator
from ..hmatrix.hmatrix import DenseBucket
from ..utils.profiling import count, span
from .krylov import CGGraphs, KrylovResult, block_gmres, cg, gmres

__all__ = [
    "build_geometric_overlap",
    "SchwarzPreconditioner",
    "BLRSchwarzPreconditioner",
    "DDMSolver",
]


def build_geometric_overlap(
    tree: ClusterTree, n_layers_or_radius: float = 0.0
) -> list[np.ndarray]:
    """Per-partition overlap index sets (cluster numbering), by geometric
    radius: points of other partitions within ``radius`` of the partition's
    own points.  Returns, per partition, the OVERLAP-ONLY indices (interior
    excluded), sorted."""
    from scipy.spatial import cKDTree

    offs, sizes = tree.partition_offsets_sizes()
    P = tree.n_partitions
    pts_c = tree.points[tree.permutation]  # cluster-ordered coordinates
    radius = float(n_layers_or_radius)
    out = []
    with span("htool.schwarz.overlap"):  # host work only
        kd = cKDTree(pts_c)
        for p in range(P):
            off, sz = int(offs[p]), int(sizes[p])
            if radius <= 0:
                out.append(np.zeros(0, np.int64))
                continue
            near = kd.query_ball_point(pts_c[off : off + sz], r=radius)
            idx = np.unique(np.concatenate([np.asarray(a, np.int64) for a in near]))
            mask = (idx < off) | (idx >= off + sz)
            out.append(idx[mask])
    return out


@dataclass
class SchwarzPreconditioner:
    """Batched one-level Schwarz preconditioner over cluster numbering.

    ``idx [P, n_max]`` global cluster indices per subdomain (padded with the
    trash slot N), ``weights [P, n_max]`` scatter weights (0 on padding; D
    on overlap per variant), and the precomputed local inverses
    ``inv [P, n_max, n_max]``; the apply is one batched matmul."""

    n_global: int
    idx: torch.Tensor  # [P, n_max] int64 (== n_global on padding)
    weights: torch.Tensor  # [P, n_max] real
    inv: torch.Tensor  # [P, n_max, n_max] explicit local inverses
    variant: str = "ras"
    n_sub_sizes: np.ndarray = None  # host [P]

    def apply(self, r):
        """r: [N, k] cluster numbering -> z [N, k]."""
        with span("htool.schwarz.apply", device=r):
            squeeze = r.ndim == 1
            if squeeze:
                r = r[:, None]
            z = _schwarz_apply(self.idx, self.weights, self.inv, r)
            return z[:, 0] if squeeze else z

    def __call__(self, r):
        return self.apply(r)


def _schwarz_apply(idx, weights, inv, r):
    N, k = r.shape
    r_pad = torch.cat([r, torch.zeros((1, k), dtype=r.dtype, device=r.device)])
    r_loc = r_pad[idx]  # [P, n_max, k]; the trash row is zero
    z_loc = inv.to(r.dtype) @ r_loc
    z_loc = z_loc * weights[..., None].to(z_loc.dtype)
    z = torch.zeros((N + 1, k), dtype=r.dtype, device=r.device)
    z.index_add_(0, idx.reshape(-1), z_loc.reshape(-1, k))
    return z[:N]


def _build_schwarz(
    generator: Generator,
    tree: ClusterTree,
    overlap: Optional[list[np.ndarray]],
    variant: str,
    dtype,
) -> SchwarzPreconditioner:
    offs, sizes = tree.partition_offsets_sizes()
    P = tree.n_partitions
    N = tree.n_points
    perm = tree.permutation
    device = generator.device

    subs = []
    for p in range(P):
        off, sz = int(offs[p]), int(sizes[p])
        interior = np.arange(off, off + sz)
        ov = (
            overlap[p]
            if (overlap is not None and variant in ("asm", "ras"))
            else np.zeros(0, np.int64)
        )
        subs.append((interior, ov))

    n_max = max(int(i.size + o.size) for i, o in subs)
    idx = np.full((P, n_max), N, np.int64)
    wts = np.zeros((P, n_max), np.float64)
    for p, (interior, ov) in enumerate(subs):
        ni, no = interior.size, ov.size
        idx[p, :ni] = interior
        idx[p, ni : ni + no] = ov
        wts[p, :ni] = 1.0
        if variant == "asm":
            wts[p, ni : ni + no] = 1.0  # no partition of unity
        # ras: overlap weight stays 0 (restricted)

    # assemble local dense matrices batched: rows/cols in user numbering
    perm_ext = np.concatenate([perm, [0]])  # trash slot maps to any point
    with span("htool.schwarz.local", sync=device):
        rows_user = torch.as_tensor(perm_ext[idx], device=device)  # [P, n_max]
        A_loc = generator.block(rows_user, rows_user)
        # zero padded rows/cols, identity on padded diagonal to keep LU valid
        valid = torch.as_tensor(idx < N, device=device)
        A_loc.masked_fill_(~(valid[:, :, None] & valid[:, None, :]), 0)
        A_loc.diagonal(dim1=1, dim2=2).add_((~valid).to(A_loc.dtype))
        inv = torch.linalg.inv(A_loc)
        del A_loc

    real = torch.empty((), dtype=dtype).real.dtype
    return SchwarzPreconditioner(
        n_global=N,
        idx=torch.as_tensor(idx, device=device),
        weights=torch.as_tensor(wts, dtype=real, device=device),
        inv=inv,
        variant=variant,
        n_sub_sizes=np.array([i.size + o.size for i, o in subs]),
    )


@dataclass
class BLRSchwarzPreconditioner:
    """One-level Schwarz with BLR-compressed local factorizations — the
    H-LU local solver mode (``LocalHMatrixSolver``,
    ``solvers/local_solvers/local_hmatrix_solvers.hpp:14-85``): each
    subdomain matrix is assembled as a BLR (or two-level BLR) matrix and
    LU-factorized in compressed form, so large subdomains stay
    sub-quadratic in memory.  The apply solves each subdomain in turn."""

    n_global: int
    idx: list  # per-subdomain global cluster indices (int64 tensors)
    weights: list  # per-subdomain scatter weights (real tensors)
    factors: list  # per-subdomain factorized BLRMatrix or TwoLevelBLR
    variant: str = "ras"

    def apply(self, r):
        from ..hmatrix.blr import blr_solve
        from ..hmatrix.blr2 import TwoLevelBLR, blr2_solve

        with span("htool.schwarz.apply", device=r):
            squeeze = r.ndim == 1
            if squeeze:
                r = r[:, None]
            z = torch.zeros_like(r)
            for idx, w, F in zip(self.idx, self.weights, self.factors):
                solve = blr2_solve if isinstance(F, TwoLevelBLR) else blr_solve
                z_loc = solve(F, r[idx], user_numbering=True)
                z.index_add_(0, idx, (z_loc * w[:, None].to(z_loc.dtype)).to(z.dtype))
            return z[:, 0] if squeeze else z

    def __call__(self, r):
        return self.apply(r)

    def memory_bytes(self) -> int:
        """Bytes of the local factors."""
        return sum(F.memory_bytes() for F in self.factors)


def _build_blr_schwarz(
    generator: Generator,
    tree: ClusterTree,
    overlap: Optional[list[np.ndarray]],
    variant: str,
    blr_epsilon: float = 1e-6,
    blr_block_size: int = 256,
    hierarchical: bool = False,
    coarse_size: int = 2048,
) -> BLRSchwarzPreconditioner:
    from ..clustering.cluster_tree import ClusterTreeBuilder
    from ..generator import SubsetGenerator
    from ..hmatrix.blr import blr_lu, build_blr
    from ..hmatrix.blr2 import blr2_lu, build_blr2

    offs, sizes = tree.partition_offsets_sizes()
    perm = tree.permutation
    device = generator.device
    real = torch.empty((), dtype=generator.dtype).real.dtype

    idxs, wtss, factors = [], [], []
    for p in range(tree.n_partitions):
        off, sz = int(offs[p]), int(sizes[p])
        interior = np.arange(off, off + sz)
        ov = (np.asarray(overlap[p], np.int64)
              if (overlap is not None and variant in ("asm", "ras"))
              else np.zeros(0, np.int64))
        idx = np.concatenate([interior, ov])
        w = np.ones(idx.size)
        if variant == "ras":
            w[interior.size :] = 0.0
        sub_user = perm[idx]
        sub_tree = ClusterTreeBuilder(
            max_leaf_size=min(blr_block_size, max(32, idx.size // 8))
        ).build(tree.points[sub_user])
        sub_gen = SubsetGenerator(generator, sub_user)
        if hierarchical and idx.size > 2 * coarse_size:
            # hierarchical local factorization (the reference's H-LU local
            # solver, local_hmatrix_solvers.hpp:14-85, with recursive
            # asymptotics via the two-level panel format)
            B2 = build_blr2(sub_gen, sub_tree, epsilon=blr_epsilon, coarse_size=coarse_size,
                            block_size=blr_block_size)
            factors.append(blr2_lu(B2, error_estimate=False))
        else:
            B = build_blr(sub_gen, sub_tree, epsilon=blr_epsilon, block_size=blr_block_size)
            factors.append(blr_lu(B))
        idxs.append(torch.as_tensor(idx, device=device))
        wtss.append(torch.as_tensor(w, dtype=real, device=device))
    return BLRSchwarzPreconditioner(n_global=tree.n_points, idx=idxs, weights=wtss,
                                    factors=factors, variant=variant)


# devices on which CG's step is captured; off the card the graphs are
# stand-ins that run the step eagerly (a seam for the CPU tests)
_GRAPH_DEVICES = ("cuda",)


def _graph_inputs(H, precond) -> tuple:
    """What CG's captured graphs read besides its own vectors: the
    operator's buckets, their blocks and plans, and the preconditioner's
    tensors.  Graphs captured over other objects than these are stale."""
    out = [precond]
    if precond is not None:
        out += [precond.idx, precond.weights, precond.inv]
    for bucket in H.dense_buckets + H.lr_buckets:
        out += [bucket, bucket.plan_t, bucket.plan_s, bucket.pair]
        out += [bucket.data] if isinstance(bucket, DenseBucket) else [bucket.U, bucket.V]
    return tuple(out)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DDMSolver:
    """One-level (and, with a coarse space attached, two-level) Schwarz-
    preconditioned Krylov solver — the ``DDM`` equivalent
    (``solvers/ddm.hpp:29-382``).

    ``operator`` may be an :class:`~htool_tpu_torch.hmatrix.hmatrix.HMatrix`,
    a :class:`~htool_tpu_torch.parallel.distributed.DistributedHMatrix`
    (applied through its l2l product, the vectors replicated), or any
    callable on cluster-numbered [N, k] tensors.  The solve runs in
    cluster numbering internally and accepts/returns user numbering, like
    the reference (ddm.hpp:179,226).
    """

    def __init__(
        self,
        operator,
        generator: Generator,
        tree: ClusterTree,
        schwarz: str = "ras",
        overlap: Optional[list[np.ndarray]] = None,
        overlap_radius: float = 0.0,
        coarse=None,  # optional GeneoCoarseSpace
        coarse_correction: str = "additive",
        local_solver: str = "dense",  # "dense" | "blr" (flat) | "blr2" (hierarchical)
        blr_epsilon: float = 1e-6,
        blr_block_size: int = 256,
        blr_coarse_size: int = 2048,
    ):
        self.tree = tree
        self.generator = generator
        self.schwarz = schwarz
        self.device = generator.device
        self.infos: dict = {}
        self._perm = torch.as_tensor(tree.permutation, device=self.device)  # one copy, not one a solve

        from ..hmatrix.hmatrix import HMatrix
        from ..hmatrix.linalg import matvec as h_matvec
        from ..parallel.distributed import DistributedHMatrix

        self._hmatrix = None  # an HMatrix operator, whose products CG can replay
        self._graphs: Optional[CGGraphs] = None
        if isinstance(operator, HMatrix):
            self._apply = lambda x: h_matvec(operator, x, op="N")
            self._hmatrix = operator
            dtype = operator.dtype
        elif isinstance(operator, DistributedHMatrix):
            d = operator
            self._apply = lambda x: d.to_global_layout(d.matvec_local(d.to_local_layout(x)))
            dtype = d.dtype
        else:
            self._apply = operator
            dtype = generator.dtype

        t0 = time.perf_counter()
        if schwarz in ("jacobi", "asm", "ras"):
            if overlap is None and overlap_radius > 0 and schwarz in ("asm", "ras"):
                overlap = build_geometric_overlap(tree, overlap_radius)
            if local_solver in ("blr", "blr2"):
                self.precond = _build_blr_schwarz(
                    generator, tree, overlap, schwarz, blr_epsilon, blr_block_size,
                    hierarchical=(local_solver == "blr2"), coarse_size=blr_coarse_size,
                )
                self.infos["Local_solver"] = local_solver
            elif local_solver == "dense":
                self.precond = _build_schwarz(generator, tree, overlap, schwarz, dtype)
                self.infos["Local_solver"] = "dense"
                self.infos["Local_size_max"] = int(self.precond.n_sub_sizes.max())
            else:
                raise ValueError(f"unknown local solver {local_solver!r}")
            _sync(self.device)
            self.infos["Precond"] = schwarz
            self.infos["Nb_subdomains"] = tree.n_partitions
        elif schwarz == "none":
            self.precond = None
            self.infos["Precond"] = "none"
        else:
            raise ValueError(f"unknown schwarz variant {schwarz!r}")
        self.infos["Facto_one_level_walltime"] = time.perf_counter() - t0

        self.coarse = coarse
        self.coarse_correction = coarse_correction
        if coarse is not None:
            self.infos["Coarse_correction"] = coarse_correction
            self.infos["Coarse_size"] = int(coarse.size)

    # ------------------------------------------------------------------
    def _preconditioner(self) -> Optional[Callable]:
        one = self.precond.apply if self.precond is not None else None
        if self.coarse is None:
            return one
        return self.coarse.combined_preconditioner(one, self._apply, self.coarse_correction)

    def _cg_graphs(self, b) -> Optional[CGGraphs]:
        """CG's graphs for a solve of ``b`` (cluster numbering), captured
        again when what they read has changed; None where the solve is
        issued eagerly: off a CUDA device, with another operator than an
        HMatrix, a coarse space, another preconditioner than the dense
        Schwarz apply, or an operator wider than b."""
        H, pre = self._hmatrix, self.precond
        if (H is None or self.coarse is not None or b.device.type not in _GRAPH_DEVICES
                or not (pre is None or isinstance(pre, SchwarzPreconditioner))
                or torch.promote_types(H.dtype, b.dtype) != b.dtype):
            return None
        key = _graph_inputs(H, pre)
        old = self._graphs
        if old is None or len(old.key) != len(key) or any(a is not c for a, c in zip(old.key, key)):
            self._graphs = CGGraphs(key)
        return self._graphs

    def solve(
        self,
        b,
        tol: float = 1e-6,
        maxiter: int = 200,
        krylov: str = "gmres",
        restart: int = 40,
        x0=None,
    ):
        """Solve A x = b in USER numbering.  Returns (x, infos)."""
        with span("htool.ddm.solve"):
            b = torch.as_tensor(b, device=self.device)
            squeeze = b.ndim == 1
            if squeeze:
                b = b[:, None]
            perm = self._perm
            bc = b[perm]

            M = self._preconditioner()
            t0 = time.perf_counter()
            if krylov == "cg":
                result: KrylovResult = cg(self._apply, bc, M=M, tol=tol, maxiter=maxiter, x0=x0,
                                          _graphs=self._cg_graphs(bc))
            elif krylov == "gmres":
                result = gmres(
                    self._apply, bc, M=M, tol=tol, maxiter=maxiter, restart=restart, x0=x0
                )
            elif krylov == "block_gmres":
                result = block_gmres(
                    self._apply, bc, M=M, tol=tol, maxiter=maxiter, restart=restart, x0=x0
                )
            else:
                raise ValueError(f"unknown krylov method {krylov!r}")
            xc = result.x
            if self.device.type == "cuda":
                count("syncs")
                with span("htool.krylov.wait"):
                    _sync(self.device)
            self.infos["Solve_walltime"] = time.perf_counter() - t0
            self.infos["Krylov"] = krylov
            self.infos["Nb_it"] = int(result.iterations)
            self.infos["Residual"] = float(result.residual)
            self.infos["Converged"] = bool(result.converged)

            x = torch.empty_like(xc)
            x[perm] = xc
            return (x[:, 0] if squeeze else x), dict(self.infos)
