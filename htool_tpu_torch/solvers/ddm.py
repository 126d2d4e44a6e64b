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
counts stay comparable with the reference.  The BLR local solvers and the
GenEO coarse space are not ported yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..clustering.cluster_tree import ClusterTree
from ..generator import Generator
from .krylov import KrylovResult, cg, gmres

__all__ = [
    "build_geometric_overlap",
    "SchwarzPreconditioner",
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DDMSolver:
    """One-level Schwarz-preconditioned Krylov solver — the ``DDM``
    equivalent (``solvers/ddm.hpp:29-382``).

    ``operator`` may be an :class:`~htool_tpu_torch.hmatrix.hmatrix.HMatrix`
    or any callable on cluster-numbered [N, k] tensors.  The solve runs in
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
        coarse=None,
        local_solver: str = "dense",
    ):
        if coarse is not None:
            raise NotImplementedError(
                "two-level DDM (coarse=) is not ported yet (ROADMAP Queue 1 item 9, GenEO)"
            )
        if local_solver in ("blr", "blr2"):
            raise NotImplementedError(
                f"local_solver={local_solver!r} is not ported yet (ROADMAP Queue 1 item 10)"
            )
        self.tree = tree
        self.generator = generator
        self.schwarz = schwarz
        self.device = generator.device
        self.infos: dict = {}

        from ..hmatrix.hmatrix import HMatrix
        from ..hmatrix.linalg import matvec as h_matvec

        if isinstance(operator, HMatrix):
            self._apply = lambda x: h_matvec(operator, x, op="N")
            dtype = operator.dtype
        else:
            self._apply = operator
            dtype = generator.dtype

        t0 = time.perf_counter()
        if schwarz in ("jacobi", "asm", "ras"):
            if overlap is None and overlap_radius > 0 and schwarz in ("asm", "ras"):
                overlap = build_geometric_overlap(tree, overlap_radius)
            if local_solver != "dense":
                raise ValueError(f"unknown local solver {local_solver!r}")
            self.precond = _build_schwarz(generator, tree, overlap, schwarz, dtype)
            _sync(self.device)
            self.infos["Local_solver"] = "dense"
            self.infos["Local_size_max"] = int(self.precond.n_sub_sizes.max())
            self.infos["Precond"] = schwarz
            self.infos["Nb_subdomains"] = tree.n_partitions
        elif schwarz == "none":
            self.precond = None
            self.infos["Precond"] = "none"
        else:
            raise ValueError(f"unknown schwarz variant {schwarz!r}")
        self.infos["Facto_one_level_walltime"] = time.perf_counter() - t0

    # ------------------------------------------------------------------
    def _preconditioner(self) -> Optional[Callable]:
        return self.precond.apply if self.precond is not None else None

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
        b = torch.as_tensor(b, device=self.device)
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        perm = torch.as_tensor(self.tree.permutation, device=self.device)
        bc = b[perm]

        M = self._preconditioner()
        t0 = time.perf_counter()
        if krylov == "cg":
            result: KrylovResult = cg(self._apply, bc, M=M, tol=tol, maxiter=maxiter, x0=x0)
        elif krylov == "gmres":
            result = gmres(
                self._apply, bc, M=M, tol=tol, maxiter=maxiter, restart=restart, x0=x0
            )
        else:
            raise ValueError(f"unknown krylov method {krylov!r}")
        xc = result.x
        _sync(self.device)
        self.infos["Solve_walltime"] = time.perf_counter() - t0
        self.infos["Krylov"] = krylov
        self.infos["Nb_it"] = int(result.iterations)
        self.infos["Residual"] = float(result.residual)
        self.infos["Converged"] = bool(result.converged)

        x = torch.empty_like(xc)
        x[perm] = xc
        return (x[:, 0] if squeeze else x), dict(self.infos)
