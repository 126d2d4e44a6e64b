"""Distributed DDM solve — the whole Krylov iteration on partition slices.

Port of ``htool_tpu/solvers/dist_ddm.py`` (the reference's HPDDM-driven
solve on local slices, ``solvers/ddm.hpp:183-214`` +
``wrappers/wrapper_hpddm.hpp:102-149``): each partition holds only its
slice of the right-hand side, the operator product is the distributed l2l
product, the Schwarz preconditioner exchanges subdomain intersections with
its neighbours and solves each subdomain locally, and dot products are
completed with a ``psum``.  The JAX package wraps the whole solve in one
``shard_map``; here every per-partition tensor keeps a leading partition
axis on the mesh's device and the collectives are those of
:mod:`..parallel.collectives`:

- Krylov vectors are the padded interior slices ``[P_local·m_loc_max, k]``
  (:func:`.krylov.cg` / ``gmres`` / ``block_gmres`` with ``mesh=``);
- the halo exchange over precomputed subdomain-intersection index sets runs
  as a static sequence of ``ppermute`` rounds, one per colour of the
  edge-coloured neighbour graph (the ``exchange`` of wrapper_hpddm.hpp:140-149);
- subdomain solves: the dense mode is one batched LU of the padded
  extended subdomains ``[P_local, n_ext_max, n_ext_max]`` and, per
  application, a row gather and two batched triangular solves
  (``local_dense_solvers.hpp``); the BLR mode
  factors one compressed LU per subdomain (:mod:`..hmatrix.blr`), pads them
  to one shape (:class:`StackedBLRFactors`) and runs each block sweep once
  for all local subdomains (``local_hmatrix_solvers.hpp:14-85``): nL steps,
  each batched over the partitions, where the JAX package runs each
  device's sweep in its ``shard_map`` body;
- the GenEO coarse correction applies on local slices with one ``psum`` for
  Zᴴ r and a replicated small solve (``coarse_operator_builder.hpp``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..clustering.cluster_tree import ClusterTree
from ..generator import Generator
from ..parallel.collectives import ppermute, psum
from ..parallel.distributed import DistributedHMatrix
from .ddm import _sync, build_geometric_overlap
from .krylov import block_gmres, cg, gmres

__all__ = ["HaloExchange", "DistributedDDMSolver", "StackedBLRFactors", "build_halo_exchange"]


# ======================================================================
# halo exchange plan (host) + apply
# ======================================================================


@dataclass
class HaloExchange:
    """Static ``ppermute`` schedule for the subdomain-intersection exchange.

    Built on the host from the overlap decomposition: directed edges
    (owner q -> borrower p) carry the values of q's interior rows that lie
    in p's overlap.  Edges are greedily coloured so that within a colour
    every partition is the source of at most one edge and the destination
    of at most one edge — each colour is then a single ``ppermute`` of an
    ``[H_max, k]`` packed buffer (the reference's point-to-point
    ``exchange``, wrapper_hpddm.hpp:140).  The tables are NumPy arrays over
    all P partitions.
    """

    P: int
    m_loc_max: int  # interior slice pad
    n_ext_max: int  # interior+overlap pad
    n_colors: int
    perms: tuple  # per colour: tuple of (src, dst) pairs
    # per colour c: send rows (interior-local) and receive positions (ext),
    # [C, P, H_max]; pads: send -> row 0, recv -> trash row n_ext_max
    send_idx: np.ndarray
    recv_pos: np.ndarray
    # layout maps, [P, n_ext_max] / [P, m_loc_max]
    ext_src: np.ndarray  # ext position -> interior-local row (m_loc_max = zero)
    int_src: np.ndarray  # interior-local row -> ext position (n_ext_max = zero)
    ext_sizes: np.ndarray = None  # [P]

    @property
    def H_max(self) -> int:
        return int(self.send_idx.shape[-1])


def build_halo_exchange(tree: ClusterTree, overlap: list) -> HaloExchange:
    """Host plan: per-partition ext layout [interior; overlap] and the
    coloured intersection exchange (the data the reference loads as
    ``neighbors_*`` / ``intersections_*``, test_solver_ddm.hpp:110-183)."""
    offs, sizes = tree.partition_offsets_sizes()
    Pn = tree.n_partitions
    m_loc_max = int(sizes.max())

    ext_idx = []
    for p in range(Pn):
        off, sz = int(offs[p]), int(sizes[p])
        ov = np.asarray(overlap[p], np.int64) if overlap is not None else np.zeros(0, np.int64)
        ext_idx.append(np.concatenate([np.arange(off, off + sz), ov]))
    n_ext_max = max(int(e.size) for e in ext_idx)

    # directed edges (q -> p): values of q's interior needed by p's overlap
    edges = []  # (src q, dst p, send_local_rows, recv_ext_positions)
    for p in range(Pn):
        sz = int(sizes[p])
        ov = ext_idx[p][sz:]
        if ov.size == 0:
            continue
        owner = np.searchsorted(offs, ov, side="right") - 1
        for q in np.unique(owner):
            sel = np.nonzero(owner == q)[0]
            send_rows = ov[sel] - int(offs[q])  # interior-local rows in q
            recv_pos = sz + sel  # ext positions in p
            edges.append((int(q), int(p), send_rows, recv_pos))

    # greedy edge colouring: per colour, distinct sources and destinations
    colors: list = []
    for e in edges:
        q, p = e[0], e[1]
        for c in colors:
            if all(q != e2[0] and p != e2[1] for e2 in c):
                c.append(e)
                break
        else:
            colors.append([e])
    C = max(1, len(colors))
    H_max = max((len(e[2]) for e in edges), default=1)

    send_idx = np.zeros((C, Pn, H_max), np.int32)
    recv_pos = np.full((C, Pn, H_max), n_ext_max, np.int32)
    perms = []
    for ci in range(C):
        group = colors[ci] if ci < len(colors) else []
        perms.append(tuple((e[0], e[1]) for e in group))
        for q, p, srows, rpos in group:
            send_idx[ci, q, : srows.size] = srows
            recv_pos[ci, p, : rpos.size] = rpos

    ext_src = np.full((Pn, n_ext_max), m_loc_max, np.int32)
    int_src = np.full((Pn, m_loc_max), n_ext_max, np.int32)
    for p in range(Pn):
        sz = int(sizes[p])
        ext_src[p, :sz] = np.arange(sz)
        int_src[p, :sz] = np.arange(sz)

    return HaloExchange(
        P=Pn, m_loc_max=m_loc_max, n_ext_max=n_ext_max, n_colors=C, perms=tuple(perms),
        send_idx=send_idx, recv_pos=recv_pos, ext_src=ext_src, int_src=int_src,
        ext_sizes=np.array([e.size for e in ext_idx]),
    )


def _rows_of(a, idx):
    """Per partition, the rows ``idx`` of ``a``: [Pl, n, k], [Pl, h] -> [Pl, h, k]."""
    return torch.gather(a, 1, idx[:, :, None].expand(-1, -1, a.shape[2]))


def _halo_gather(halo: HaloExchange, mesh, r_int, send_idx, recv_pos, ext_src):
    """The extended-subdomain slices from the interior slices and the
    neighbours' values (forward exchange): r_int [P_local, m_loc_max, k] ->
    r_ext [P_local, n_ext_max, k] (pads zero).  ``send_idx``/``recv_pos``
    are this process's columns of the plan, [C, P_local, H_max]; ``ext_src``
    [P_local, n_ext_max]."""
    Pl, _, k = r_int.shape
    zero = torch.zeros((Pl, 1, k), dtype=r_int.dtype, device=r_int.device)
    r_pad = torch.cat([r_int, zero], dim=1)
    r_ext = torch.cat([_rows_of(r_pad, ext_src), zero], dim=1)  # trash row last
    for c in range(halo.n_colors):
        if not halo.perms[c]:
            continue
        got = ppermute(_rows_of(r_int, send_idx[c]), halo.perms[c], mesh)  # [Pl, H, k]
        r_ext.scatter_(1, recv_pos[c][:, :, None].expand(-1, -1, k), got)
    return r_ext[:, :-1]


def _halo_scatter_add(halo: HaloExchange, mesh, z_ext, z_int, send_idx, recv_pos):
    """Reverse exchange: send overlap contributions back to their owners'
    interior rows and ADD (the ASM Σ Rᵢᵀ term)."""
    Pl, _, k = z_ext.shape
    z_ext_pad = torch.cat([z_ext, torch.zeros((Pl, 1, k), dtype=z_ext.dtype,
                                              device=z_ext.device)], dim=1)
    for c in range(halo.n_colors):
        if not halo.perms[c]:
            continue
        rev = tuple((dst, src) for (src, dst) in halo.perms[c])
        got = ppermute(_rows_of(z_ext_pad, recv_pos[c]), rev, mesh)  # borrowed, going home
        z_int = z_int.scatter_add(1, send_idx[c][:, :, None].expand(-1, -1, k), got)
    return z_int


# ======================================================================
# stacked BLR local solver (compressed subdomain factorizations)
# ======================================================================


@dataclass
class StackedBLRFactors:
    """The local subdomains' factorized BLR matrices padded to one shape, so
    that one block sweep serves all of them (the LocalHMatrixSolver role,
    ``local_hmatrix_solvers.hpp:14-85``).

    Every tensor is ``[P_local, ...]`` on the mesh's device; slot tables
    index each subdomain's OWN slots.  Padding: a subdomain's cells of size
    b < B get the identity on the rest of their diagonal cell and identity
    pivots; its padded sweep steps visit a trash row nL (zero, and left
    zero) through its zero dummy slots, with the identity cell at slot
    ``ndm − 1`` as their diagonal."""

    B: int  # common cell size
    nL: int  # common cell count (padded)
    Rh: int  # common rank slice
    D: torch.Tensor  # [P, ndm, B, B]
    U: torch.Tensor  # [P, nlm, B, Rb]
    V: torch.Tensor  # [P, nlm, Rb, B]
    piv: torch.Tensor  # [P, nL, B] int32, 1-based row swaps
    pad_idx: torch.Tensor  # [P, nL, B] int64 ext rows (n_ext_max: a zero row)
    mask: torch.Tensor  # [P, nL, B] bool
    cells2ext: torch.Tensor  # [P, n_ext_max] int64 into the flattened cells (pads: trash row)
    fwd: tuple  # (order, dsl, dj, lsl, lj, dgs), each [P, nL, ...] int64
    bwd: tuple
    _cast: dict = field(default_factory=dict, repr=False)

    def cells(self, dtype: torch.dtype) -> tuple:
        """(D, U, V) in ``dtype``, cast once and kept."""
        if dtype == self.D.dtype:
            return self.D, self.U, self.V
        if dtype not in self._cast:
            self._cast[dtype] = (self.D.to(dtype), self.U.to(dtype), self.V.to(dtype))
        return self._cast[dtype]


def _stack_blr_factors(factors: list, n_ext_max: int, device=None) -> StackedBLRFactors:
    """Pad the factorized BLR matrices of the local subdomains (each in its
    subdomain's ext-row numbering) to one shape on ``device`` (default: the
    first factor's), with sweep tables from :func:`..hmatrix.blr._sweep_tables`
    (the JAX package's ``_stack_blr_factors``)."""
    from ..hmatrix.blr import _sweep_tables

    dev = factors[0].device if device is None else torch.device(device)
    Pn = len(factors)
    B = max(F.b for F in factors)
    nL = max(F.nL for F in factors)
    Rh = max(F.R_half for F in factors)
    ndm = max(int(F.D.shape[0]) for F in factors) + 1  # + the identity cell
    nlm = max(int(F.U.shape[0]) for F in factors)
    dtype = factors[0].dtype
    for F in factors[1:]:
        dtype = torch.promote_types(dtype, F.dtype)

    D = torch.zeros((Pn, ndm, B, B), dtype=dtype, device=dev)
    U = torch.zeros((Pn, nlm, B, 2 * Rh), dtype=dtype, device=dev)
    V = torch.zeros((Pn, nlm, 2 * Rh, B), dtype=dtype, device=dev)
    piv = torch.arange(1, B + 1, dtype=torch.int32, device=dev).repeat(Pn, nL, 1)
    pad_idx = np.full((Pn, nL, B), n_ext_max, np.int64)
    mask = np.zeros((Pn, nL, B), bool)
    cells2ext = np.full((Pn, n_ext_max), nL * B, np.int64)
    D[:, ndm - 1] = torch.eye(B, dtype=dtype, device=dev)
    for p, F in enumerate(factors):
        b, nl_p, nd_p = F.b, F.nL, int(F.D.shape[0])
        D[p, :nd_p, :b, :b] = F.D.to(dev)
        if b < B:  # diagonal cells: the identity past b
            diag = np.unique([int(F.dense_slot[i, i]) for i in range(nl_p)])
            D[p, diag, b:, b:] = torch.eye(B - b, dtype=dtype, device=dev)
        U[p, : F.U.shape[0], :b, : F.U.shape[2]] = F.U.to(dev)
        V[p, : F.V.shape[0], : F.V.shape[1], :b] = F.V.to(dev)
        if F.piv is not None:
            piv[p, :nl_p, :b] = F.piv.to(dev)
        # cells are ranges of the subdomain's cluster ordering; the solve runs
        # in its ext-row ordering (cluster -> ext row: the permutation)
        perm = np.asarray(F.permutation, np.int64)
        for i in range(nl_p):
            off, sz = int(F.cell_off[i]), int(F.cell_size[i])
            pad_idx[p, i, :sz] = perm[off : off + sz]
            mask[p, i, :sz] = True
            cells2ext[p, perm[off : off + sz]] = i * B + np.arange(sz)

    def stack_tabs(which):
        tabs = [_sweep_tables(F, which, "N") for F in factors]
        Wd = max(t[1].shape[1] for t in tabs)
        Wl = max(t[3].shape[1] for t in tabs)
        order = np.full((Pn, nL), nL, np.int64)  # padded steps: the trash row
        dsl = np.zeros((Pn, nL, Wd), np.int64)
        dj = np.zeros((Pn, nL, Wd), np.int64)
        lsl = np.zeros((Pn, nL, Wl), np.int64)
        lj = np.zeros((Pn, nL, Wl), np.int64)
        dgs = np.full((Pn, nL), ndm - 1, np.int64)  # padded diagonal: the identity
        for p, ((o, ds, djp, ls, ljp, dg), F) in enumerate(zip(tabs, factors)):
            nl_p = o.shape[0]
            order[p, :nl_p] = o
            dsl[p] = int(F.D.shape[0]) - 1  # the subdomain's zero dummy slots
            lsl[p] = int(F.U.shape[0]) - 1
            dsl[p, :nl_p, : ds.shape[1]] = ds
            dj[p, :nl_p, : djp.shape[1]] = djp
            lsl[p, :nl_p, : ls.shape[1]] = ls
            lj[p, :nl_p, : ljp.shape[1]] = ljp
            dgs[p, :nl_p] = dg
        return tuple(torch.as_tensor(a, device=dev) for a in (order, dsl, dj, lsl, lj, dgs))

    return StackedBLRFactors(
        B=B, nL=nL, Rh=Rh, D=D, U=U, V=V, piv=piv,
        pad_idx=torch.as_tensor(pad_idx, device=dev), mask=torch.as_tensor(mask, device=dev),
        cells2ext=torch.as_tensor(cells2ext, device=dev),
        fwd=stack_tabs("L"), bwd=stack_tabs("U"),
    )


def _stacked_sweep(sf: StackedBLRFactors, D, U, V, y, tabs, lu: bool):
    """One block-triangular sweep of ``y`` [P, nL + 1, B, k] (in place) for
    all subdomains at once: step t of every subdomain gathers its row's
    off-diagonal cells and the rows they read, subtracts their products and,
    with ``lu``, solves the factored diagonal cell (one batched ``lu_solve``
    over the ``[P, B, B]`` cells); without, the block diagonal is unit."""
    order, dsl, dj, lsl, lj, dgs = tabs
    Pl = y.shape[0]
    p = torch.arange(Pl, device=y.device)
    pw = p[:, None]
    Rh = sf.Rh
    for t in range(sf.nL):
        i = order[:, t]
        acc = torch.einsum("pwij,pwjk->pik", D[pw, dsl[:, t]], y[pw, dj[:, t]])
        Uw = U[pw, lsl[:, t], :, :Rh]  # [P, Wl, B, Rh]
        Vw = V[pw, lsl[:, t], :Rh, :]  # [P, Wl, Rh, B]
        acc = acc + torch.einsum("pwir,pwrk->pik", Uw, Vw @ y[pw, lj[:, t]])
        r = y[p, i] - acc
        if lu:
            r = torch.linalg.lu_solve(D[p, dgs[:, t]], sf.piv[p, i.clamp(max=sf.nL - 1)], r)
        y[p, i] = r
    return y


def _blr_local_solve(sf: StackedBLRFactors, r_ext):
    """The compressed subdomain solves: r_ext [P_local, n_ext_max, k] ->
    z_ext, 2·nL batched steps whatever P_local (the JAX package's
    ``_blr_local_solve`` of each device, for all local subdomains).  Rows
    past a subdomain's ext size come back zero."""
    Pl, _, k = r_ext.shape
    D, U, V = sf.cells(r_ext.dtype)
    zero = torch.zeros((Pl, 1, k), dtype=r_ext.dtype, device=r_ext.device)
    y = _rows_of(torch.cat([r_ext, zero], dim=1), sf.pad_idx.reshape(Pl, -1))
    y = torch.where(sf.mask.reshape(Pl, -1, 1), y, 0).reshape(Pl, sf.nL, sf.B, k)
    y = torch.cat([y, torch.zeros_like(y[:, :1])], dim=1)  # the trash row
    y = _stacked_sweep(sf, D, U, V, y, sf.fwd, lu=False)
    y = _stacked_sweep(sf, D, U, V, y, sf.bwd, lu=True)
    return _rows_of(y.reshape(Pl, (sf.nL + 1) * sf.B, k), sf.cells2ext)


def _pivot_permutation(piv):
    """LAPACK's 1-based sequential row swaps ``piv`` [P, n] as one row
    permutation [P, n] (int64, on piv's device): ``b[perm]`` is Pᵀ b for
    A = P L U."""
    swaps = piv.cpu().numpy().astype(np.int64) - 1
    Pn, n = swaps.shape
    perm = np.tile(np.arange(n), (Pn, 1))
    rows = np.arange(Pn)
    for i in range(n):
        j = swaps[:, i]
        perm[rows, i], perm[rows, j] = perm[rows, j], perm[rows, i].copy()
    return torch.as_tensor(perm, device=piv.device)


def _lu_apply(lu, perm, r):
    """A⁻¹ r from A's LU factors ``lu`` [P, n, n] and row permutation
    ``perm`` [P, n]: the row gather and the two triangular solves of
    ``torch.linalg.lu_solve``, without the pass over the whole factors that
    ``lu_solve`` makes on each CUDA call (``tools/torch_dist_probe.py``,
    phase ``lu_solve``)."""
    y = torch.gather(r, 1, perm[:, :, None].expand(-1, -1, r.shape[2]))
    y = torch.linalg.solve_triangular(lu, y, upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(lu, y, upper=True)


def _subdomain_blr_factors(generator, tree, overlap, parts, blr_epsilon, blr_block_size):
    """One compressed LU per subdomain of ``parts``, each on the subdomain's
    own cluster tree over its ext (interior + overlap) points, in its ext-row
    numbering (the replicated solver's ``local_solver="blr"`` build)."""
    from ..clustering.cluster_tree import ClusterTreeBuilder
    from ..generator import SubsetGenerator
    from ..hmatrix.blr import blr_lu, build_blr

    offs, sizes = tree.partition_offsets_sizes()
    perm = tree.permutation
    factors = []
    for p in parts:
        off, sz = int(offs[p]), int(sizes[p])
        idx = np.concatenate([np.arange(off, off + sz), np.asarray(overlap[p], np.int64)])
        sub_user = perm[idx]
        sub_tree = ClusterTreeBuilder(
            max_leaf_size=min(blr_block_size, max(32, idx.size // 8))
        ).build(tree.points[sub_user])
        B = build_blr(SubsetGenerator(generator, sub_user), sub_tree, epsilon=blr_epsilon,
                      block_size=blr_block_size)
        factors.append(blr_lu(B))
    return factors


# ======================================================================
# solver
# ======================================================================


class DistributedDDMSolver:
    """One/two-level Schwarz-preconditioned Krylov solve on the partition
    slices of a :class:`DistributedHMatrix` — the ``DDM::solve`` path
    (ddm.hpp:127-230) with memory O(N/P + halo) per partition for all
    Krylov and preconditioner state.

    ``schwarz``: 'none' | 'jacobi' | 'asm' | 'ras'.  ``local_solver``:
    'dense' (an LU per subdomain) or 'blr' (a compressed LU per subdomain,
    block sweeps).  ``coarse``: optional GeneoCoarseSpace, replicated
    (``Z``) or local (``Z_loc``) store.
    """

    def __init__(
        self,
        dop: DistributedHMatrix,
        generator: Generator,
        tree: ClusterTree,
        schwarz: str = "ras",
        overlap: Optional[list] = None,
        overlap_radius: float = 0.0,
        coarse=None,
        coarse_correction: str = "additive",
        local_solver: str = "dense",
        blr_epsilon: float = 1e-6,
        blr_block_size: int = 256,
    ):
        if dop.shape[0] != dop.shape[1]:
            raise ValueError("DDM solve requires a square operator")
        self.dop = dop
        self.tree = tree
        self.schwarz = schwarz
        self.coarse = coarse
        self.coarse_correction = coarse_correction
        self.infos: dict = {
            "Precond": schwarz,
            "Nb_subdomains": tree.n_partitions,
            "Local_solver": local_solver if schwarz != "none" else "-",
        }
        mesh = dop.mesh
        dev = mesh.device
        lo, hi = mesh.lo, mesh.hi
        offs, sizes = tree.partition_offsets_sizes()

        t0 = time.perf_counter()
        if schwarz == "none":
            self.halo = None
            self._mode = "none"
        elif schwarz in ("jacobi", "asm", "ras"):
            if overlap is None and overlap_radius > 0 and schwarz in ("asm", "ras"):
                overlap = build_geometric_overlap(tree, overlap_radius)
            if schwarz == "jacobi" or overlap is None:
                overlap = [np.zeros(0, np.int64) for _ in range(tree.n_partitions)]
            self.halo = build_halo_exchange(tree, overlap)
            self._mode = local_solver
            # this process's columns of the plan, on the device
            h = self.halo
            self._send_idx = torch.as_tensor(h.send_idx[:, lo:hi], dtype=torch.int64, device=dev)
            self._recv_pos = torch.as_tensor(h.recv_pos[:, lo:hi], dtype=torch.int64, device=dev)
            self._ext_src = torch.as_tensor(h.ext_src[lo:hi], dtype=torch.int64, device=dev)
            self._int_src = torch.as_tensor(h.int_src[lo:hi], dtype=torch.int64, device=dev)
            if local_solver == "dense":
                self._setup_dense(generator, tree, overlap)
            elif local_solver == "blr":
                self._setup_blr(generator, tree, overlap, blr_epsilon, blr_block_size)
            else:
                raise ValueError(f"unknown local solver {local_solver!r}")
            self.infos["Local_size_max"] = int(h.n_ext_max)
        else:
            raise ValueError(f"unknown schwarz variant {schwarz!r}")
        _sync(dev)
        self.infos["Facto_one_level_walltime"] = time.perf_counter() - t0

        self._Z_loc = None
        if coarse is not None:
            self.infos["Coarse_correction"] = coarse_correction
            self.infos["Coarse_size"] = int(coarse.size)
            m = dop.m_loc_max
            if coarse.Z_loc is not None:
                # local store: per-partition COMPACT columns [m_loc_max, nu_max];
                # partition p's coarse slots are [p·nu_max, (p+1)·nu_max) —
                # nothing [N, nc]-sized exists
                Zc = coarse.Z_loc[lo:hi].to(dev)
                Zl = torch.zeros((mesh.n_local, m, Zc.shape[2]), dtype=Zc.dtype, device=dev)
                w = min(m, Zc.shape[1])
                Zl[:, :w] = Zc[:, :w]
            else:
                # replicated store: each partition holds its rows of the full
                # [N, nc] basis
                Z = coarse.Z.to(dev)
                Zl = torch.zeros((mesh.n_local, m, Z.shape[1]), dtype=Z.dtype, device=dev)
                for i, p in enumerate(range(lo, hi)):
                    off, sz = int(offs[p]), int(sizes[p])
                    Zl[i, :sz] = Z[off : off + sz]
            self._Z_loc = Zl

    # ------------------------------------------------------------------
    def _ext_user_rows(self, tree, overlap):
        """Per local subdomain: ext (interior+overlap) indices in USER
        numbering, padded to n_ext_max with the first point (masked out)."""
        offs, sizes = tree.partition_offsets_sizes()
        perm = tree.permutation
        mesh = self.dop.mesh
        rows = np.zeros((mesh.n_local, self.halo.n_ext_max), np.int64)
        valid = np.zeros(rows.shape, bool)
        for i, p in enumerate(range(mesh.lo, mesh.hi)):
            off, sz = int(offs[p]), int(sizes[p])
            idx = np.concatenate([np.arange(off, off + sz), np.asarray(overlap[p], np.int64)])
            rows[i, : idx.size] = perm[idx]
            valid[i, : idx.size] = True
        return rows, valid

    def _setup_dense(self, generator, tree, overlap):
        rows, valid = self._ext_user_rows(tree, overlap)
        dev = self.dop.mesh.device
        rows_t = torch.as_tensor(rows, device=dev)
        vm = torch.as_tensor(valid, device=dev)
        A_loc = generator.block(rows_t, rows_t)  # [P_local, n_ext, n_ext]
        # zero padded rows/cols, identity on the padded diagonal
        A_loc.masked_fill_(~(vm[:, :, None] & vm[:, None, :]), 0)
        A_loc.diagonal(dim1=1, dim2=2).add_((~vm).to(A_loc.dtype))
        lu, piv = torch.linalg.lu_factor(A_loc)
        self._lu = {lu.dtype: lu}  # the factors by dtype, each cast once
        self._perm = _pivot_permutation(piv)

    def _setup_blr(self, generator, tree, overlap, blr_epsilon, blr_block_size):
        """One compressed LU per local subdomain, stacked for the batched
        sweeps."""
        mesh = self.dop.mesh
        factors = _subdomain_blr_factors(generator, tree, overlap, range(mesh.lo, mesh.hi),
                                         blr_epsilon, blr_block_size)
        self._sf = _stack_blr_factors(factors, self.halo.n_ext_max, mesh.device)
        self.infos["BLR_cells"] = int(self._sf.nL)

    # ------------------------------------------------------------------
    def _local_solve(self, r_ext):
        """Subdomain solves: r_ext [P_local, n_ext_max, k] -> z_ext."""
        if self._mode == "dense":
            lu = self._lu.get(r_ext.dtype)
            if lu is None:
                lu = self._lu[r_ext.dtype] = next(iter(self._lu.values())).to(r_ext.dtype)
            return _lu_apply(lu, self._perm, r_ext)
        return _blr_local_solve(self._sf, r_ext)

    def _one_level(self, r_sl):
        """M₁ on padded slices r_sl [P_local, m_loc_max, k]."""
        mesh, halo = self.dop.mesh, self.halo
        r_ext = _halo_gather(halo, mesh, r_sl, self._send_idx, self._recv_pos, self._ext_src)
        z_ext = self._local_solve(r_ext)
        k = z_ext.shape[2]
        z_ext_pad = torch.cat([z_ext, torch.zeros((z_ext.shape[0], 1, k), dtype=z_ext.dtype,
                                                  device=z_ext.device)], dim=1)
        z_int = _rows_of(z_ext_pad, self._int_src)  # interior rows (weight 1)
        if self.schwarz == "asm":
            z_int = _halo_scatter_add(halo, mesh, z_ext, z_int, self._send_idx, self._recv_pos)
        return z_int

    def _coarse_solve(self, r_sl, dtype):
        """Q r = Z E⁻¹ Zᴴ r on padded slices [P_local, m_loc_max, k]."""
        mesh, cs = self.dop.mesh, self.coarse
        Zl = self._Z_loc.to(dtype)
        k = r_sl.shape[2]
        mu_l = Zl.mH @ r_sl  # [P_local, nu, k]
        if cs.Z_loc is not None:
            # local store: μ embedded at the partition's slot offset and
            # psum'd (coarse_operator_builder.hpp:18-129 distributed)
            nu_max = cs.nu_max
            Pl = mesh.n_local
            mu = torch.zeros((Pl, mesh.n_partitions, nu_max, k), dtype=dtype,
                             device=r_sl.device)
            i = torch.arange(Pl, device=r_sl.device)
            mu[i, mesh.lo + i] = mu_l
            mu = mu.reshape(Pl, -1, k)
            e = torch.linalg.lu_solve(cs.E_lu.to(dtype), cs.E_piv, psum(mu, mesh))
            e_loc = e.reshape(mesh.n_partitions, nu_max, k)[mesh.lo : mesh.hi]
        else:
            e = torch.linalg.lu_solve(cs.E_lu.to(dtype), cs.E_piv, psum(mu_l, mesh))
            e_loc = e[None]
        return Zl @ e_loc

    # ------------------------------------------------------------------
    def solve(
        self,
        b,
        tol: float = 1e-6,
        maxiter: int = 200,
        krylov: str = "gmres",
        restart: int = 40,
    ):
        """Solve A x = b in USER numbering; returns (x, infos).  Every
        process of the mesh passes the whole b and gets the whole x."""
        d = self.dop
        mesh = d.mesh
        Pl, m = mesh.n_local, d.m_loc_max
        b = torch.as_tensor(b, device=mesh.device)
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        k = b.shape[1]
        perm = torch.as_tensor(self.tree.permutation, device=mesh.device)
        dtype = torch.promote_types(d.dtype, b.dtype)
        b_loc = d.to_local_layout(b[perm]).to(dtype)  # [P_local·m_loc_max, k]

        def A_apply(x_sl):
            return d._l2l(x_sl, "N")

        def sl(v):
            return v.reshape(Pl, m, v.shape[-1])

        M = None
        if self.halo is not None:
            def M1(r):
                return self._one_level(sl(r)).reshape(Pl * m, -1)

            M = M1
            if self.coarse is not None:
                def Q(r):
                    return self._coarse_solve(sl(r), r.dtype).reshape(Pl * m, -1)

                if self.coarse_correction == "additive":
                    def M(r):
                        return M1(r) + Q(r)
                elif self.coarse_correction == "deflated":
                    def M(r):
                        Qr = Q(r)
                        return Qr + M1(r - A_apply(Qr))
                elif self.coarse_correction == "balanced":
                    def M(r):
                        Qr = Q(r)
                        t = M1(r - A_apply(Qr))
                        return Qr + t - Q(A_apply(t))
                else:
                    raise ValueError(f"unknown coarse correction {self.coarse_correction!r}")

        t0 = time.perf_counter()
        if krylov == "cg":
            res = cg(A_apply, b_loc, M=M, tol=tol, maxiter=maxiter, mesh=mesh)
        elif krylov == "gmres":
            res = gmres(A_apply, b_loc, M=M, tol=tol, maxiter=maxiter, restart=restart,
                        mesh=mesh)
        elif krylov == "block_gmres":
            res = block_gmres(A_apply, b_loc, M=M, tol=tol, maxiter=maxiter, restart=restart,
                              mesh=mesh)
        else:
            raise ValueError(f"unknown krylov method {krylov!r}")
        xc = d.to_global_layout(res.x)
        _sync(mesh.device)
        self.infos["Solve_walltime"] = time.perf_counter() - t0
        self.infos["Krylov"] = krylov
        self.infos["Nb_it"] = int(res.iterations)
        self.infos["Residual"] = float(res.residual)
        self.infos["Converged"] = bool(res.converged)

        x = torch.zeros_like(xc)
        x[perm] = xc
        return (x[:, 0] if squeeze else x), dict(self.infos)
