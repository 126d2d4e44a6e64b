"""Two-level (hierarchical) block low-rank factorization.

Port of ``htool_tpu/hmatrix/blr2.py`` (the reference's recursive
H-LU/H-Cholesky, ``hmatrix/linalg/factorization.hpp:19-79`` LU, ``:131-205``
Cholesky, task-parallel variant ``task_based_factorization.hpp:33-213``).
The hierarchy has two levels, or three with nested diagonal panels:

- **level 1 — coarse panels** (cluster-tree nodes at the ``coarse_size``
  level): every off-diagonal panel pair is ONE low-rank factor
  ``U_IJ [P, R] · V_IJ [R, P]`` under *weak admissibility*, assembled by a
  chunked batched ACA over all pairs;
- **level 2 — the diagonal panels**, stacked dense ``[nC, P, P]`` (one
  batched LU/Cholesky per step, exact dense Schur absorption), per-panel
  one-level BLR matrices over the global tree's finer level, or — nested —
  per-panel :class:`TwoLevelBLR` matrices (three levels in all).

The right-looking panel factorization

    for K:  factor diag_K;  V_IK <- V_IK·U_K⁻¹;  U_KJ <- L_K⁻¹·P_Kᵀ·U_KJ;
            A_IJ -= (U_IK V_IK)(U_KJ V_KJ)   (fused low-rank add+truncate)

runs as batched torch ops per step: triangular solves over the active panel
row and column, then ONE gather + matmul + batched QR/SVD re-truncation over
all trailing pairs (chunked to a byte budget).  The reference's padding of
the active pair sets to powers of two bounded XLA compiles and is not
ported; the panel ``lax.scan``s of the solves become loops over panels.
Rank-capped pairs are counted; the build escalates the cap (accuracy guard).

``perms`` holds each diagonal panel's row permutation (A_K[perm] = L_K U_K),
as the reference keeps ``jax.lax.linalg.lu``'s permutation.

Storage invariant: stored factor columns beyond ``pRank[I, J]`` are zero.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, Optional

import numpy as np
import torch

from ..clustering.cluster_tree import ClusterTree
from ..generator import Generator
from .aca import batched_partial_aca
from .block_tree import rjasanow_steinbach
from .blr import (
    DENSE,
    LR,
    BLRMatrix,
    _cells_plan,
    _grid_cells,
    _index,
    blr_cholesky,
    blr_lu,
    blr_matvec,
    blr_triangular_solve,
)
from .compressors import batched_recompress, svd_truncation_rank

__all__ = [
    "TwoLevelBLR",
    "build_blr2",
    "blr2_lu",
    "blr2_cholesky",
    "blr2_solve",
    "blr2_triangular_solve",
    "blr2_matvec",
    "blr2_backward_error",
]


# ======================================================================
# container
# ======================================================================


@dataclass
class TwoLevelBLR:
    """Coarse-panel two-level compressed matrix (cluster numbering).

    Off-diagonal panels live in ``pU [nC, nC, P, R]`` / ``pV [nC, nC, R, P]``
    with per-pair ranks ``pRank [nC, nC]`` (diagonal slots zero).  The
    diagonal is ``Dd [nC, P, P]`` (``diag_mode='dense'``) or a list of
    per-panel :class:`BLRMatrix` or nested :class:`TwoLevelBLR`
    (``diag_mode='blr'``)."""

    n: int
    panel_off: np.ndarray  # [nC]
    panel_size: np.ndarray  # [nC]
    P: int  # padded panel size
    diag_mode: str  # "dense" | "blr"
    pU: Any  # [nC, nC, P, R]
    pV: Any  # [nC, nC, R, P]
    pRank: Any  # [nC, nC] int32 on the device
    Dd: Any = None  # [nC, P, P] dense diagonal panels (dense mode)
    diag: Optional[list] = None  # [nC] BLRMatrix or TwoLevelBLR (blr mode)
    perms: Any = None  # [nC, P] int64 row permutations of the diag LU
    R: int = 128  # stored panel rank cap
    epsilon: float = 1e-6
    factorized: bool = False
    kind: str = "lu"  # "lu" | "chol" once factorized
    permutation: np.ndarray = None  # cluster -> user (global tree)
    info: dict = field(default_factory=dict)
    cache: dict = field(default_factory=dict, repr=False)

    @property
    def nC(self) -> int:
        return int(self.panel_off.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.pU.dtype

    @property
    def device(self) -> torch.device:
        return self.pU.device

    def memory_bytes(self) -> int:
        total = self.pU.numel() * self.pU.element_size() * 2
        if self.diag_mode == "dense":
            total += self.Dd.numel() * self.Dd.element_size()
        else:
            for B in self.diag:
                if isinstance(B, TwoLevelBLR):
                    total += B.memory_bytes()  # nested panel (>= 3 levels)
                else:
                    total += B.D.numel() * B.D.element_size()
                    total += B.U.numel() * B.U.element_size() * 2
        return int(total)

    def stored_entries(self) -> int:
        """Scalars a product reads: the off-diagonal factors at their ranks
        and the diagonal (dense panels, or each panel's own count)."""
        rk = self.pRank.cpu().numpy()
        off = ~np.eye(self.nC, dtype=bool)
        stored = 2 * self.P * int(rk[off].sum())
        if self.diag_mode == "dense":
            return stored + self.nC * self.P * self.P
        for B in self.diag:
            if isinstance(B, TwoLevelBLR):
                stored += B.stored_entries()
                continue
            brk = B.ranks.cpu().numpy()
            stored += int((B.cls == DENSE).sum()) * B.b * B.b
            for i, j in zip(*np.nonzero(B.cls == LR)):
                stored += 2 * B.b * int(brk[B.lr_slot[i, j]])
        return stored

    def compression_info(self) -> dict:
        """n², over :meth:`stored_entries`.  The JAX package rebuilds a nested
        panel's count from its rounded ratio (``int(n² / ratio)``); this
        sums the exact counts, so nested ratios may differ in the last
        digits."""
        stored = self.stored_entries()
        rk = self.pRank.cpu().numpy()
        return dict(
            n_panels=self.nC,
            diag_mode=self.diag_mode,
            rank_max=int(rk.max()) if rk.size else 0,
            compression_ratio=float(self.n) * self.n / stored if stored else float("inf"),
        )

    def to_dense(self, user_numbering: bool = False) -> np.ndarray:
        nCi = self.nC
        pU, pV = self.pU.cpu().numpy(), self.pV.cpu().numpy()
        A = np.zeros((self.n, self.n), pU.dtype)
        for I in range(nCi):
            oI, sI = int(self.panel_off[I]), int(self.panel_size[I])
            if self.diag_mode == "dense":
                A[oI : oI + sI, oI : oI + sI] = self.Dd[I].cpu().numpy()[:sI, :sI]
            else:
                A[oI : oI + sI, oI : oI + sI] = self.diag[I].to_dense()
            for J in range(nCi):
                if I == J:
                    continue
                oJ, sJ = int(self.panel_off[J]), int(self.panel_size[J])
                A[oI : oI + sI, oJ : oJ + sJ] = (pU[I, J] @ pV[I, J])[:sI, :sJ]
        if user_numbering:
            out = np.zeros_like(A)
            out[np.ix_(self.permutation, self.permutation)] = A
            return out
        return A


# ======================================================================
# assembly
# ======================================================================


def _pow2(n: int, lo: int = 1) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _panel_gather_idx(perm, offs, szs, sel, P):
    """User-numbering row indices per panel in ``sel``, padded (clamped)."""
    ar = np.arange(P)[None, :]
    rel = np.minimum(ar, szs[sel][:, None] - 1)
    return perm[offs[sel][:, None] + rel]


def _pad_mask(szs_rows, szs_cols, P, device):
    """[c, P, P] mask of the true rows × cols of each block."""
    ar = torch.arange(P, device=device)
    r = ar[None, :] < _index(szs_rows, device)[:, None]
    c = ar[None, :] < _index(szs_cols, device)[:, None]
    return r[:, :, None] & c[:, None, :]


def _offdiag_aca(generator, perm, offs, szs, pairs, P, epsilon, R, chunk):
    """Chunked batched ACA over panel pairs -> (U [np,P,R], V [np,R,P] on the
    device, rank host, failed host).  The factors stay on the device (one
    slice write per chunk); only the rank/failed vectors reach the host.
    Columns past a block's rank are zeroed (failed blocks: all)."""
    device = generator.device
    npairs = pairs.shape[0]
    U_out = torch.zeros((npairs, P, R), dtype=generator.dtype, device=device)
    V_out = torch.zeros((npairs, R, P), dtype=generator.dtype, device=device)
    rank_out = np.zeros((npairs,), np.int32)
    failed_out = np.zeros((npairs,), bool)
    ar = torch.arange(R, device=device)
    for c0 in range(0, npairs, chunk):
        c1 = min(c0 + chunk, npairs)
        isel, jsel = pairs[c0:c1, 0], pairs[c0:c1, 1]
        U, V, rank, failed = batched_partial_aca(
            generator,
            _index(_panel_gather_idx(perm, offs, szs, isel, P), device),
            _index(_panel_gather_idx(perm, offs, szs, jsel, P), device),
            _index(szs[isel], device),
            _index(szs[jsel], device),
            epsilon,
            R,
        )
        keep = ar[None, :] < rank[:, None]
        U_out[c0:c1] = U * keep[:, None, :].to(U.dtype)
        V_out[c0:c1] = V * keep[:, :, None].to(V.dtype)
        rank_out[c0:c1] = rank.cpu().numpy()
        failed_out[c0:c1] = failed.cpu().numpy()
        del U, V
    return U_out, V_out, rank_out, failed_out


def _build_diag_dense(generator, perm, offs, szs, nC, P):
    """Stacked dense diagonal panels with identity on the padding rows."""
    idx = _index(_panel_gather_idx(perm, offs, szs, np.arange(nC), P), generator.device)
    Dd = generator.block(idx, idx)  # [nC, P, P]
    Dd.masked_fill_(~_pad_mask(szs, szs, P, generator.device), 0)
    for I in range(nC):
        Dd[I].diagonal()[int(szs[I]) :] = 1
    return Dd


def _build_diag_blr(generator, tree, offs, szs, epsilon, eta, block_size, R_half):
    """Per-panel one-level BLR diagonal matrices built from the GLOBAL
    cluster tree's finer level, with all panels' low-rank cells compressed
    in ONE batched ACA call and all dense cells gathered in one call."""
    perm = tree.permutation
    nC = int(offs.shape[0])
    device, dtype = generator.device, generator.dtype
    # fine cells per panel (descendants of the panel node)
    fine_cells, f_offs, f_szs, _ = _grid_cells(tree, block_size)
    ends = offs + szs
    owner = np.searchsorted(offs, f_offs, side="right") - 1
    if not (f_offs + f_szs <= ends[owner]).all():
        raise ValueError("fine cells must nest in panels")
    b = max(8, int(-(-int(f_szs.max()) // 8) * 8))
    if R_half is None:
        R_half = max(16, min(b // 2, 64))
    R_half = int(-(-R_half // 8) * 8)
    R_buf = 2 * R_half

    # classify cell pairs inside each panel
    panel_fine = [np.nonzero(owner == I)[0] for I in range(nC)]
    lr_list, dn_list = [], []  # (panel, local i, local j, fine ci, fine cj)
    for I in range(nC):
        loc = panel_fine[I]
        for a, ci in enumerate(loc):
            for c, cj in enumerate(loc):
                ti, sj = fine_cells[ci], fine_cells[cj]
                adm = a != c and rjasanow_steinbach(
                    tree.centers[ti], tree.radii[ti], tree.centers[sj], tree.radii[sj], eta)
                (lr_list if adm else dn_list).append((I, a, c, ci, cj))

    ar = np.arange(b)[None, :]

    def fine_gidx(cells_sel):
        rel = np.minimum(ar, f_szs[cells_sel][:, None] - 1)
        return _index(perm[f_offs[cells_sel][:, None] + rel], device)

    # one batched ACA for ALL panels' LR cells
    lr_arr = np.array(lr_list, np.int64).reshape(-1, 5)
    failed_all = np.zeros(lr_arr.shape[0], bool)
    if lr_arr.shape[0]:
        U_all, V_all, rank_all, failed_all = batched_partial_aca(
            generator, fine_gidx(lr_arr[:, 3]), fine_gidx(lr_arr[:, 4]),
            _index(f_szs[lr_arr[:, 3]], device), _index(f_szs[lr_arr[:, 4]], device),
            epsilon, R_half)
        rank_all = rank_all.cpu().numpy()
        failed_all = failed_all.cpu().numpy()
    # failures fall back to dense (false positives, tree_builder.hpp:572-577)
    dn_arr = np.array(dn_list + [tuple(lr_arr[t]) for t in np.nonzero(failed_all)[0]],
                      np.int64).reshape(-1, 5)
    if dn_arr.shape[0]:
        D_all = generator.block(fine_gidx(dn_arr[:, 3]), fine_gidx(dn_arr[:, 4]))
        D_all.masked_fill_(~_pad_mask(f_szs[dn_arr[:, 3]], f_szs[dn_arr[:, 4]], b, device), 0)

    # split into per-panel BLRMatrix containers
    diag = []
    for I in range(nC):
        loc = panel_fine[I]
        nL = loc.size
        cls = np.zeros((nL, nL), np.int8)
        dense_slot = np.full((nL, nL), -1, np.int32)
        lr_slot = np.full((nL, nL), -1, np.int32)
        lr_sel = np.nonzero((lr_arr[:, 0] == I) & ~failed_all)[0]
        dn_sel = np.nonzero(dn_arr[:, 0] == I)[0]
        for s, t in enumerate(lr_sel):
            _, a, c, _, _ = lr_arr[t]
            cls[a, c] = LR
            lr_slot[a, c] = s
        for s, t in enumerate(dn_sel):
            _, a, c, _, _ = dn_arr[t]
            cls[a, c] = DENSE
            dense_slot[a, c] = s
        nd, nl = dn_sel.size, lr_sel.size
        D = torch.zeros((nd + 1, b, b), dtype=dtype, device=device)
        if nd:
            D[:nd] = D_all[_index(dn_sel, device)]
            for s, t in enumerate(dn_sel):
                _, a, c, ci, _ = dn_arr[t]
                if a == c:
                    D[s].diagonal()[int(f_szs[ci]) :] = 1
        U = torch.zeros((nl + 1, b, R_buf), dtype=dtype, device=device)
        V = torch.zeros((nl + 1, R_buf, b), dtype=dtype, device=device)
        if nl:
            U[:nl, :, :R_half] = U_all[_index(lr_sel, device)]
            V[:nl, :R_half, :] = V_all[_index(lr_sel, device)]
        ranks = torch.as_tensor(np.concatenate([rank_all[lr_sel] if nl else [], [0]])
                                .astype(np.int32), device=device)
        diag.append(BLRMatrix(
            n=int(szs[I]), cell_off=f_offs[loc] - offs[I], cell_size=f_szs[loc], b=b,
            cls=cls, dense_slot=dense_slot, lr_slot=lr_slot, D=D, U=U, V=V, ranks=ranks,
            R_half=R_half, epsilon=epsilon, permutation=None, info=dict(n_cells=nL)))
    return diag


def _build_diag_nested(generator, tree, offs, szs, epsilon, mid_size, R2=None, chunk=256):
    """Nested diagonal panels: each top-level panel becomes its OWN
    TwoLevelBLR over the global tree's ``mid_size``-level cells (order-
    preserving, so panel factors act directly on the parent's cluster-
    numbered slabs) — the ≥3-level factorization nesting (reference
    full-depth recursion ``factorization.hpp:19-79``).

    All panels' off-diagonal sub-pairs compress in ONE chunked batched ACA
    and all sub-diagonal dense blocks gather in one call; ACA failures fall
    back to truncated dense SVD at the R2 cap."""
    perm = tree.permutation
    nC = int(offs.shape[0])
    device, dtype = generator.device, generator.dtype
    fine_cells, f_offs, f_szs, _ = _grid_cells(tree, mid_size)
    ends = offs + szs
    owner = np.searchsorted(offs, f_offs, side="right") - 1
    if not (f_offs + f_szs <= ends[owner]).all():
        raise ValueError("mid cells must nest in panels")
    P2 = max(8, int(-(-int(f_szs.max()) // 8) * 8))
    if R2 is None:
        # quarter-panel cap: the nested format only pays off when sub-pair
        # factors are well below half-dense; epsilon-ranks beyond the cap
        # fall back to truncated SVD at the cap (counted)
        R2 = max(16, min(128, P2 // 4))
    R2 = int(_pow2(max(8, R2), 8))

    panel_fine = [np.nonzero(owner == I)[0] for I in range(nC)]
    for I in range(nC):
        if len(panel_fine[I]) < 2:
            raise ValueError(f"panel {I} has {len(panel_fine[I])} sub-cell(s) at "
                             f"mid_size={mid_size}; lower mid_size")

    pair_meta, pair_cells = [], []  # (panel, a, c), (fine ci, fine cj)
    for I in range(nC):
        loc = panel_fine[I]
        for a in range(len(loc)):
            for c in range(len(loc)):
                if a != c:
                    pair_meta.append((I, a, c))
                    pair_cells.append((loc[a], loc[c]))
    pair_cells = np.array(pair_cells, np.int64).reshape(-1, 2)
    chunk = int(min(chunk, _pow2(max(1, pair_cells.shape[0]))))
    Up, Vp, rank, failed = _offdiag_aca(generator, perm, f_offs, f_szs, pair_cells, P2,
                                        epsilon, R2, chunk)
    n_capped = 0
    if failed.any():
        # dense-SVD fallback at the R2 cap for inadmissible sub-pairs
        sel = np.nonzero(failed)[0]
        ci, cj = pair_cells[sel, 0], pair_cells[sel, 1]
        blk = generator.block(_index(_panel_gather_idx(perm, f_offs, f_szs, ci, P2), device),
                              _index(_panel_gather_idx(perm, f_offs, f_szs, cj, P2), device))
        blk.masked_fill_(~_pad_mask(f_szs[ci], f_szs[cj], P2, device), 0)
        Uf, s, Vh = torch.linalg.svd(blk, full_matrices=False)
        rk = svd_truncation_rank(s, epsilon)
        n_capped = int((rk > R2).sum())
        rk = torch.clamp(rk, max=R2)
        keep = torch.arange(R2, device=device)[None, :] < rk[:, None]
        sv = torch.where(keep, s[:, :R2], 0)
        sel_d = _index(sel, device)
        Up[sel_d] = Uf[:, :, :R2] * sv[:, None, :].to(dtype)
        Vp[sel_d] = Vh[:, :R2, :] * keep[:, :, None].to(dtype)
        rank[sel] = rk.cpu().numpy()
        del blk, Uf, Vh

    # one batched gather for every sub-diagonal dense block
    diag_cells = np.concatenate(panel_fine)
    Dd_all = _build_diag_dense(generator, perm, f_offs[diag_cells], f_szs[diag_cells],
                               diag_cells.shape[0], P2)

    # panel pair stores by device gather (the dummy last row covers the
    # zero diagonal slots)
    n_pairs = pair_cells.shape[0]
    Up_ext = torch.cat([Up, torch.zeros((1,) + Up.shape[1:], dtype=dtype, device=device)])
    Vp_ext = torch.cat([Vp, torch.zeros((1,) + Vp.shape[1:], dtype=dtype, device=device)])
    del Up, Vp
    pair_meta = np.array(pair_meta, np.int64).reshape(-1, 3)
    panels, pos = [], 0
    for I in range(nC):
        ns = len(panel_fine[I])
        idx_map = np.full((ns, ns), n_pairs, np.int64)
        pR = np.zeros((ns, ns), np.int32)
        for t in np.nonzero(pair_meta[:, 0] == I)[0]:
            _, a, c = pair_meta[t]
            idx_map[a, c] = t
            pR[a, c] = rank[t]
        gat = _index(idx_map.reshape(-1), device)
        panels.append(TwoLevelBLR(
            n=int(szs[I]),
            panel_off=f_offs[panel_fine[I]] - int(offs[I]),
            panel_size=f_szs[panel_fine[I]].copy(),
            P=P2,
            diag_mode="dense",
            pU=Up_ext[gat].reshape(ns, ns, P2, R2),
            pV=Vp_ext[gat].reshape(ns, ns, R2, P2),
            pRank=torch.as_tensor(pR, device=device),
            Dd=Dd_all[pos : pos + ns].clone(),
            R=R2,
            epsilon=float(epsilon),
            permutation=np.arange(int(szs[I])),
            info=dict(nested_panel=True, n_rank_capped_pairs=n_capped),
        ))
        pos += ns
    return panels


def build_blr2(
    generator: Generator,
    tree: ClusterTree,
    epsilon: float = 1e-6,
    coarse_size: Optional[int] = None,
    R: Optional[int] = None,
    diag_mode: str = "auto",
    block_size: int = 512,
    eta: float = 10.0,
    R_half: Optional[int] = None,
    dense_diag_budget: int = 2 << 30,
    chunk: int = 256,
    auto_escalate: int = 1,
    mid_size: Optional[int] = None,
    mid_R: Optional[int] = None,
) -> TwoLevelBLR:
    """Assemble the two-level matrix on the generator's device: every
    off-diagonal panel pair as one low-rank factor (weak admissibility,
    chunked batched ACA), diagonal panels dense-stacked, flat-BLR, or NESTED
    TwoLevelBLR (``diag_mode="nested"`` — three factorization levels, the
    reference's full-depth recursion asymptotics, factorization.hpp:19-79;
    panel sub-grid at ``mid_size``, default P/8 clamped to >= 512).
    ``"auto"`` takes ``"dense"`` while the dense diagonal fits
    ``dense_diag_budget`` bytes, else ``"nested"``.

    ``R`` is the stored panel rank cap; pairs whose ε-rank exceeds it are
    re-compressed after a global cap escalation (``auto_escalate`` rounds),
    as :func:`..hmatrix.blr.blr_lu`'s accuracy guard does.

    ``coarse_size=None`` scales the panel size with the problem
    (pow2(n/16) clamped to [4096, 16384]): panel-pair memory grows as
    nC²·P·R = (n/P)²·P·R, so larger problems need LARGER panels, and
    interface panel ranks grow only mildly with P."""
    if coarse_size is None:
        coarse_size = min(16384, max(4096, _pow2(tree.n_points // 16)))
    cells, offs, szs, level = _grid_cells(tree, coarse_size)
    nC = len(cells)
    if nC < 2:
        raise ValueError(
            f"coarse_size={coarse_size} yields {nC} panel(s); need >= 2 "
            "(use plain build_blr / dense factorization instead)")
    perm = tree.permutation
    P = max(8, int(-(-int(szs.max()) // 8) * 8))
    dtype, device = generator.dtype, generator.device
    itemsize = torch.empty((), dtype=dtype).element_size()
    if R is None:
        R = min(128, P // 2)
    R = int(_pow2(max(8, R), 8))
    if diag_mode == "auto":
        diag_mode = "dense" if nC * P * P * itemsize <= dense_diag_budget else "nested"
    if diag_mode not in ("dense", "blr", "nested"):
        raise ValueError(f"unknown diag_mode {diag_mode!r}")
    t0 = time.perf_counter()

    pairs = np.array([(I, J) for I in range(nC) for J in range(nC) if I != J], np.int64)
    chunk = int(min(chunk, _pow2(pairs.shape[0])))
    t_aca0 = time.perf_counter()
    Up, Vp, rank, failed = _offdiag_aca(generator, perm, offs, szs, pairs, P, epsilon, R, chunk)
    n_failed = int(failed.sum())
    while n_failed and auto_escalate > 0:
        # global cap escalation: widen buffers, re-run ACA on failed pairs
        auto_escalate -= 1
        Up = torch.nn.functional.pad(Up, (0, R))
        Vp = torch.nn.functional.pad(Vp, (0, 0, 0, R))
        R = 2 * R
        fsel = np.nonzero(failed)[0]
        Uf, Vf, rf, ff = _offdiag_aca(generator, perm, offs, szs, pairs[fsel], P, epsilon, R,
                                      int(min(chunk, _pow2(fsel.size))))
        Up[_index(fsel, device)], Vp[_index(fsel, device)] = Uf, Vf
        rank[fsel], failed[fsel] = rf, ff
        n_failed = int(failed.sum())
        del Uf, Vf
    if n_failed:
        # last resort — store failed pairs EXACTLY as (block, identity)
        # factors: the panel analog of the reference's ACA-failure -> dense
        # fallback (tree_builder.hpp:572-577).  Needs R >= P.
        if R < P:
            R2 = int(_pow2(P, 8))
            Up = torch.nn.functional.pad(Up, (0, R2 - R))
            Vp = torch.nn.functional.pad(Vp, (0, 0, 0, R2 - R))
            R = R2
        for t in np.nonzero(failed)[0]:
            I, J = int(pairs[t, 0]), int(pairs[t, 1])
            blk = generator.block(
                _index(_panel_gather_idx(perm, offs, szs, np.array([I]), P), device),
                _index(_panel_gather_idx(perm, offs, szs, np.array([J]), P), device))
            blk.masked_fill_(~_pad_mask(szs[[I]], szs[[J]], P, device), 0)
            sJ = int(szs[J])
            Up[t].zero_()
            Vp[t].zero_()
            Up[t, :, :P] = blk[0]
            Vp[t, :sJ, :sJ] = torch.eye(sJ, dtype=dtype, device=device)
            rank[t] = sJ

    # the [nC, nC, P, R] pair store, diagonal slots zero
    pU = torch.zeros((nC, nC, P, R), dtype=dtype, device=device)
    pV = torch.zeros((nC, nC, R, P), dtype=dtype, device=device)
    pi, pj = _index(pairs[:, 0], device), _index(pairs[:, 1], device)
    pU[pi, pj] = Up
    del Up
    pV[pi, pj] = Vp
    del Vp
    pRank = np.zeros((nC, nC), np.int32)
    pRank[pairs[:, 0], pairs[:, 1]] = rank

    t_aca = time.perf_counter() - t_aca0
    t_diag0 = time.perf_counter()
    nested = False
    Dd, diag = None, None
    if diag_mode == "dense":
        Dd = _build_diag_dense(generator, perm, offs, szs, nC, P)
    elif diag_mode == "nested":
        if mid_size is None:
            mid_size = max(512, _pow2(P // 8))
        diag = _build_diag_nested(generator, tree, offs, szs, epsilon, mid_size, R2=mid_R,
                                  chunk=chunk)
        # nested panels go through the same per-panel machinery as flat-BLR
        # panels (polymorphic dispatch)
        diag_mode = "blr"
        nested = True
    else:
        diag = _build_diag_blr(generator, tree, offs, szs, epsilon, eta, block_size, R_half)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    return TwoLevelBLR(
        n=tree.n_points,
        panel_off=offs,
        panel_size=szs,
        P=P,
        diag_mode=diag_mode,
        pU=pU,
        pV=pV,
        pRank=torch.as_tensor(pRank, device=device),
        Dd=Dd,
        diag=diag,
        R=R,
        epsilon=float(epsilon),
        permutation=perm,
        info=dict(
            n_panels=nC,
            coarse_level=level,
            panel_rank_cap=R,
            n_aca_failed=n_failed,
            nested_diag=nested,
            n_levels=3 if nested else 2,
            offdiag_aca_walltime=t_aca,
            diag_build_walltime=time.perf_counter() - t_diag0,
            build_walltime=time.perf_counter() - t0,
        ),
    )


# ======================================================================
# factorization
# ======================================================================

# byte budget for one Schur-update batch (the Wu/Wv concatenations and the
# batched QR/SVD workspace of the fused re-truncation); pairs are chunked
# to stay under it
_SCHUR_CHUNK_BUDGET = int(2e9)


def _blr_apply_pending(B: BLRMatrix, Uc, Vc, eps) -> BLRMatrix:
    """A copy of the BLR panel ``B`` with the pending low-rank update U·V
    applied cell-wise (dense cells add exactly; LR cells re-truncate) — the
    level-2 absorption.  ``B`` itself is left as it was."""
    nL, Rh = B.nL, B.R_half
    pad_idx, mask, _ = _cells_plan(B)
    Ur = torch.where(mask[:, :, None], Uc[pad_idx], 0).to(B.dtype)  # [nL, b, R]
    Vcl = torch.where(mask[:, None, :], Vc[:, pad_idx].permute(1, 0, 2), 0).to(B.dtype)
    D, U, V, ranks = B.D.clone(), B.U.clone(), B.V.clone(), B.ranks.clone()

    di, dj = np.nonzero(B.cls == DENSE)
    if di.size:
        D.index_add_(0, _index(B.dense_slot[di, dj], B.device),
                     Ur[_index(di, B.device)] @ Vcl[_index(dj, B.device)])
    li, lj = np.nonzero(B.cls == LR)
    if li.size:
        slots = _index(B.lr_slot[li, lj], B.device)
        Wu = torch.cat([U[slots], Ur[_index(li, B.device)]], dim=2)
        Wv = torch.cat([V[slots], Vcl[_index(lj, B.device)]], dim=1)
        full = torch.full((Wu.shape[0],), Wu.shape[2], dtype=torch.int32, device=B.device)
        U2, V2, r2 = batched_recompress(Wu, Wv, full, eps)
        w = U.shape[2]
        r2c = torch.clamp(r2, max=Rh)
        keep = torch.arange(w, device=B.device)[None, :] < r2c[:, None]
        U[slots] = U2[:, :, :w] * keep[:, None, :].to(B.dtype)
        V[slots] = V2[:, :w, :] * keep[:, :, None].to(B.dtype)
        ranks[slots] = r2c.to(ranks.dtype)
    return replace(B, D=D, U=U, V=V, ranks=ranks, info=dict(B.info), cache={})


def _blr2_apply_pending(T: "TwoLevelBLR", Uc, Vc, eps) -> "TwoLevelBLR":
    """A copy of the UNfactorized nested panel ``T`` with a pending low-rank
    update ``Uc·Vc`` (panel-local) applied: diagonal sub-panels absorb the
    dense restriction exactly; off-diagonal sub-pairs append the restricted
    factors and re-truncate in one batched QR+SVD — the level-3 analog of
    :func:`_blr_apply_pending`.  ``T`` itself is left as it was."""
    nCs, R = T.nC, T.R
    Ucp = _panels_pack(T, Uc.to(T.dtype))  # [nCs, P2, Rc]
    Vcp = _panels_pack(T, Vc.to(T.dtype).mT).mT  # [nCs, Rc, P2]
    Dd = T.Dd + Ucp @ Vcp
    pU, pV, pRank = T.pU.clone(), T.pV.clone(), T.pRank.clone()
    I, J = np.nonzero(~np.eye(nCs, dtype=bool))
    if I.size:
        Id, Jd = _index(I, T.device), _index(J, T.device)
        Wu = torch.cat([pU[Id, Jd], Ucp[Id]], dim=2)
        Wv = torch.cat([pV[Id, Jd], Vcp[Jd]], dim=1)
        full = torch.full((I.size,), Wu.shape[2], dtype=torch.int32, device=T.device)
        U2, V2, r2 = batched_recompress(Wu, Wv, full, eps)
        r2c = torch.clamp(r2, max=R)
        keep = torch.arange(R, device=T.device)[None, :] < r2c[:, None]
        pU[Id, Jd] = U2[:, :, :R] * keep[:, None, :].to(T.dtype)
        pV[Id, Jd] = V2[:, :R, :] * keep[:, :, None].to(T.dtype)
        pRank[Id, Jd] = r2c.to(pRank.dtype)
    return replace(T, Dd=Dd, pU=pU, pV=pV, pRank=pRank, info=dict(T.info), cache={})


def _panel_apply_pending(B, Uc, Vc, eps):
    if isinstance(B, TwoLevelBLR):
        return _blr2_apply_pending(B, Uc, Vc, eps)
    return _blr_apply_pending(B, Uc, Vc, eps)


def _panel_factorize(B, eps, herm):
    if isinstance(B, TwoLevelBLR):
        return (blr2_cholesky if herm else blr2_lu)(B, eps, error_estimate=False)
    return (blr_cholesky if herm else blr_lu)(B, eps, auto_escalate=0, error_estimate=False)


def _panel_tri_solve(F, slab, which, trans):
    if isinstance(F, TwoLevelBLR):
        return blr2_triangular_solve(F, slab, which=which, trans=trans)
    return blr_triangular_solve(F, slab, which=which, side="L", trans=trans)


def _lu_permutation(LU, piv):
    """The row permutation p of an LU factorization (A[p] = L U) from
    LAPACK's row swaps, on the device."""
    P = torch.lu_unpack(LU, piv, unpack_data=False)[0]  # A = P L U
    return P.real.argmax(dim=-2)


def _factorize(A: TwoLevelBLR, eps: float, kind: str, error_estimate: bool) -> TwoLevelBLR:
    nC, P, R = A.nC, A.P, A.R
    herm = kind == "chol"
    dev = A.device
    t0 = time.perf_counter()
    pU, pV, pRank = A.pU.clone(), A.pV.clone(), A.pRank.clone()
    capped = torch.zeros((nC, nC), dtype=torch.int32, device=dev)
    # per-step truncation error accumulates over the nC elimination steps
    # (backward error ~ nC·eps when truncating at eps), so intermediates
    # truncate at eps/nC to land the FACTORIZATION at ~eps
    eps_int = eps / max(1, nC)

    if A.diag_mode == "dense":
        Dd = A.Dd.clone()
        perms = torch.arange(P, device=dev).repeat(nC, 1)
        diag = None
    else:
        Dd = perms = None
        diag = list(A.diag)
        peU = torch.zeros((nC, P, R), dtype=A.dtype, device=dev)
        peV = torch.zeros((nC, R, P), dtype=A.dtype, device=dev)

    for K in range(nC):
        act_h = np.arange(K + 1, nC)

        # 1. diagonal factorization
        if A.diag_mode == "dense":
            if herm:
                Dd[K] = torch.linalg.cholesky_ex(Dd[K])[0]
            else:
                LU, piv = torch.linalg.lu_factor_ex(Dd[K])[:2]
                Dd[K] = LU
                perms[K] = _lu_permutation(LU, piv)
        else:
            if K > 0:
                diag[K] = _panel_apply_pending(diag[K], peU[K], peV[K], eps_int)
            diag[K] = _panel_factorize(diag[K], eps_int, herm)

        if act_h.size == 0:
            break
        act = _index(act_h, dev)
        c = act_h.size

        # 2. panel transforms
        if A.diag_mode == "dense":
            if herm:  # V_IK <- V_IK · L_K⁻ᴴ
                pV[act, K] = torch.linalg.solve_triangular(Dd[K].mH, pV[act, K], upper=True,
                                                           left=False)
            else:  # V_IK <- V_IK · U_K⁻¹;  U_KJ <- L_K⁻¹ · P_Kᵀ · U_KJ
                pV[act, K] = torch.linalg.solve_triangular(Dd[K], pV[act, K], upper=True,
                                                           left=False)
                pU[K, act] = torch.linalg.solve_triangular(
                    Dd[K], pU[K, act][:, perms[K], :], upper=False, unitriangular=True)
        else:
            FK = diag[K]
            nK = int(A.panel_size[K])

            def solve_pad(slab, which, trans):
                # slab [P, m]: the panel factor only spans the true nK rows
                X = _panel_tri_solve(FK, slab[:nK], which, trans)
                return torch.nn.functional.pad(X, (0, 0, 0, P - nK))

            # stacked slab solves through the panel factors
            Vik = pV[act, K]  # [c, R, P]
            if herm:  # V_IK <- V_IK L_K⁻ᴴ:  Xᴴ = L_K⁻¹ Vᴴ
                X = solve_pad(Vik.conj().resolve_conj().permute(2, 0, 1).reshape(P, c * R), "L", "N")
                pV[act, K] = X.reshape(P, c, R).permute(1, 2, 0).conj().to(pV.dtype)
            else:
                X = solve_pad(Vik.permute(2, 0, 1).reshape(P, c * R), "U", "T")
                pV[act, K] = X.reshape(P, c, R).permute(1, 2, 0).to(pV.dtype)
                Y = solve_pad(pU[K, act].permute(1, 0, 2).reshape(P, c * R), "L", "N")
                pU[K, act] = Y.reshape(P, c, R).permute(1, 0, 2).to(pU.dtype)

        # 3. Schur updates on trailing off-diagonal pairs (lower triangle only
        # for Cholesky), chunked so the re-truncation's workspace stays under
        # a fixed byte budget
        pi_h, pj_h = np.meshgrid(act_h, act_h, indexing="ij")
        off = pi_h != pj_h if not herm else pi_h > pj_h
        pi_h, pj_h = pi_h[off], pj_h[off]
        if pi_h.size:
            per_pair = P * 4 * R * pU.element_size() * 6  # Wu+Wv+QR transients
            chunk = max(1, min(_SCHUR_CHUNK_BUDGET // per_pair, pi_h.size))
            for lo in range(0, pi_h.size, chunk):
                pi, pj = _index(pi_h[lo : lo + chunk], dev), _index(pj_h[lo : lo + chunk], dev)
                Uik, Vik = pU[pi, K], pV[pi, K]
                if herm:
                    Ukj, Vkj = pV[pj, K].mH, pU[pj, K].mH
                else:
                    Ukj, Vkj = pU[K, pj], pV[K, pj]
                Uc = -(Uik @ (Vik @ Ukj))
                Wu = torch.cat([pU[pi, pj], Uc], dim=2)  # [c, P, 2R]
                Wv = torch.cat([pV[pi, pj], Vkj], dim=1)  # [c, 2R, P]
                full = torch.full((Wu.shape[0],), 2 * R, dtype=torch.int32, device=dev)
                U2, V2, r2 = batched_recompress(Wu, Wv, full, eps_int)
                del Wu, Wv
                r2c = torch.clamp(r2, max=R)
                keep = torch.arange(R, device=dev)[None, :] < r2c[:, None]
                pU[pi, pj] = U2[:, :, :R] * keep[:, None, :].to(pU.dtype)
                pV[pi, pj] = V2[:, :R, :] * keep[:, :, None].to(pV.dtype)
                pRank[pi, pj] = r2c.to(pRank.dtype)
                capped[pi, pj] = torch.maximum(capped[pi, pj], (r2 > R).to(capped.dtype))

        # 4. Schur updates on trailing diagonal panels
        Uik, Vik = pU[act, K], pV[act, K]
        if herm:
            Uki, Vki = pV[act, K].mH, pU[act, K].mH
        else:
            Uki, Vki = pU[K, act], pV[K, act]
        Uc = Uik @ (Vik @ Uki)  # [c, P, R]
        if A.diag_mode == "dense":
            Dd.index_add_(0, act, Uc @ Vki, alpha=-1)
        else:
            # pending low-rank update of each trailing panel, re-truncated
            Wu = torch.cat([peU[act], -Uc], dim=2)
            Wv = torch.cat([peV[act], Vki], dim=1)
            full = torch.full((c,), 2 * R, dtype=torch.int32, device=dev)
            U2, V2, r2 = batched_recompress(Wu, Wv, full, eps_int)
            r2c = torch.clamp(r2, max=R)
            keep = torch.arange(R, device=dev)[None, :] < r2c[:, None]
            peU[act] = U2[:, :, :R] * keep[:, None, :].to(peU.dtype)
            peV[act] = V2[:, :R, :] * keep[:, :, None].to(peV.dtype)

    out = replace(A, pU=pU, pV=pV, pRank=pRank, Dd=Dd, diag=diag, perms=perms, epsilon=eps,
                  factorized=True, kind=kind, info=dict(A.info), cache={})
    out.info["n_rank_capped_pairs"] = int(capped.sum())  # syncs: the time is the device's
    out.info[f"{kind}_walltime"] = time.perf_counter() - t0
    if error_estimate:
        out.info["backward_error_est"] = blr2_backward_error(A, out, n_probe=2)
    return out


def blr2_lu(A: TwoLevelBLR, epsilon: Optional[float] = None,
            error_estimate: bool = True) -> TwoLevelBLR:
    """Right-looking two-level panel LU — the reference's recursive H-LU one
    level up (``factorization.hpp:19-79``): factor the diagonal panel,
    transform the row/column panel factors through its triangular solves,
    and apply batched truncated low-rank Schur updates to the trailing
    panels."""
    if A.factorized:
        raise ValueError("already factorized")
    return _factorize(A, A.epsilon if epsilon is None else epsilon, "lu", error_estimate)


def blr2_cholesky(A: TwoLevelBLR, epsilon: Optional[float] = None,
                  error_estimate: bool = True) -> TwoLevelBLR:
    """Two-level panel Cholesky A = L·Lᴴ (``factorization.hpp:131-205``):
    reads the lower panel triangle of a symmetric/hermitian positive-definite
    matrix; trailing Schur updates use the hermitian form -L_IK·L_JKᴴ."""
    if A.factorized:
        raise ValueError("already factorized")
    return _factorize(A, A.epsilon if epsilon is None else epsilon, "chol", error_estimate)


# ======================================================================
# solve: loops over panels (the reference's panel lax.scans)
# ======================================================================


def _row_contrib(pU, pV, K, J, y):
    """Σ_{j in J} U_Kj (V_Kj y_j) over the stored ROW K."""
    return torch.einsum("jpr,jrk->pk", pU[K, J], pV[K, J] @ y[J])


def _col_contrib(pU, pV, K, J, y, conj=False):
    """Σ_{j in J} (U_jK V_jK)ᵀ y_j over the stored COLUMN K (ᴴ with conj)."""
    U, V = pU[J, K], pV[J, K]
    if conj:
        U, V = U.conj(), V.conj()
    return torch.einsum("jrp,jrk->pk", V, torch.einsum("jpr,jpk->jrk", U, y[J]))


def _solve_fwd_lu(F, b):
    """Forward panel sweep y_K = L_K⁻¹ P_Kᵀ (b_K − Σ_{J<K} L_KJ y_J)."""
    y = b.clone()
    for K in range(F.nC):
        r = y[K] - _row_contrib(F.pU, F.pV, K, slice(0, K), y) if K else y[K]
        y[K] = torch.linalg.solve_triangular(F.Dd[K], r[F.perms[K]], upper=False,
                                             unitriangular=True)
    return y


def _solve_bwd_lu(F, y):
    """Backward sweep x_K = U_K⁻¹ (y_K − Σ_{J>K} U_KJ x_J)."""
    x = y.clone()
    for K in range(F.nC - 1, -1, -1):
        r = x[K] - _row_contrib(F.pU, F.pV, K, slice(K + 1, F.nC), x)
        x[K] = torch.linalg.solve_triangular(F.Dd[K], r, upper=True)
    return x


def _solve_fwd_lu_trans(F, b):
    """Forward sweep of Aᵀ x = b: Ûᵀ y = b (lower triangular).  Ûᵀ block
    (K, J<K) = (U_JK·V_JK)ᵀ — the stored strict-upper pairs read by COLUMN
    K; the diagonal is U_Kᵀ (factorization.hpp:256-272 trans surface)."""
    y = b.clone()
    for K in range(F.nC):
        r = y[K] - _col_contrib(F.pU, F.pV, K, slice(0, K), y) if K else y[K]
        y[K] = torch.linalg.solve_triangular(F.Dd[K].mT, r, upper=False)
    return y


def _solve_bwd_lu_trans(F, y):
    """Backward sweep of Aᵀ x = b: L̂ᵀ x = y (unit upper triangular).  The
    diagonal is (P_Kᵀ L_K)ᵀ = L_Kᵀ P_K, so w = L_K⁻ᵀ r and x_K = P_Kᵀ w."""
    x = y.clone()
    inv = torch.argsort(F.perms, dim=1)
    for K in range(F.nC - 1, -1, -1):
        r = x[K] - _col_contrib(F.pU, F.pV, K, slice(K + 1, F.nC), x)
        w = torch.linalg.solve_triangular(F.Dd[K].mT, r, upper=True, unitriangular=True)
        x[K] = w[inv[K]]
    return x


def _solve_fwd_chol(F, b):
    y = b.clone()
    for K in range(F.nC):
        r = y[K] - _row_contrib(F.pU, F.pV, K, slice(0, K), y) if K else y[K]
        y[K] = torch.linalg.solve_triangular(F.Dd[K], r, upper=False)
    return y


def _solve_bwd_chol(F, y):
    """x_K = L_K⁻ᴴ (y_K − Σ_{J>K} L_JKᴴ x_J), from the stored lower pairs."""
    x = y.clone()
    for K in range(F.nC - 1, -1, -1):
        r = x[K] - _col_contrib(F.pU, F.pV, K, slice(K + 1, F.nC), x, conj=True)
        x[K] = torch.linalg.solve_triangular(F.Dd[K].mH, r, upper=True)
    return x


def _panels_plan(F: TwoLevelBLR):
    plan = F.cache.get("_panels")
    if plan is None:
        ar = np.arange(F.P)[None, :]
        pad_idx = np.minimum(F.panel_off[:, None] + ar, F.n - 1)
        mask = ar < F.panel_size[:, None]
        keep = np.concatenate([I * F.P + np.arange(int(sz)) for I, sz in enumerate(F.panel_size)])
        plan = (_index(pad_idx, F.device), torch.as_tensor(mask, device=F.device),
                _index(keep, F.device))
        F.cache["_panels"] = plan
    return plan


def _panels_pack(F: TwoLevelBLR, x):
    """[n, k] -> [nC, P, k] padded panel layout."""
    pad_idx, mask, _ = _panels_plan(F)
    return torch.where(mask[:, :, None], x[pad_idx], 0)


def _panels_unpack(F: TwoLevelBLR, yc):
    _, _, keep = _panels_plan(F)
    return yc.reshape(F.nC * F.P, yc.shape[-1])[keep]


def _as_rhs(F, x):
    x = torch.as_tensor(x, device=F.device)
    squeeze = x.ndim == 1
    return (x[:, None] if squeeze else x), squeeze


def blr2_triangular_solve(F: TwoLevelBLR, B, which: str = "L", trans: str = "N"):
    """Half-solve with ONE factor of a factorized dense-diag TwoLevelBLR:
    ``op(L̂)·X = B`` or ``op(Û)·X = B`` — the panel-level triangular surface
    (``triangular_hmatrix_matrix_solve.hpp:18`` one level up) that the
    three-level factorization uses for its panel transforms."""
    if not F.factorized:
        raise ValueError("factorize first (blr2_lu / blr2_cholesky)")
    if F.diag_mode != "dense":
        raise NotImplementedError(
            "panel triangular solves need dense-diag factors (innermost level)")
    B, squeeze = _as_rhs(F, B)
    b = _panels_pack(F, B.to(F.dtype))
    sweeps = {
        ("chol", "L", "N"): _solve_fwd_chol,
        ("chol", "U", "N"): _solve_bwd_chol,
        ("chol", "L", "C"): _solve_bwd_chol,  # Lᴴ x = b is the 'U' factor
        ("lu", "L", "N"): _solve_fwd_lu,
        ("lu", "U", "N"): _solve_bwd_lu,
        ("lu", "U", "T"): _solve_fwd_lu_trans,
        ("lu", "L", "T"): _solve_bwd_lu_trans,
    }
    sweep = sweeps.get((F.kind, which, trans))
    if sweep is None:
        raise NotImplementedError(f"{F.kind} half-solve {which}/{trans}")
    out = _panels_unpack(F, sweep(F, b))
    return out[:, 0] if squeeze else out


def blr2_solve(F: TwoLevelBLR, rhs, user_numbering: bool = False, trans: str = "N"):
    """Solve op(A) x = rhs with a factorized two-level matrix (the lu_solve /
    cholesky_solve surface, ``factorization.hpp:119-128,245-273``); the
    right-hand side is cast to the factors' dtype."""
    if not F.factorized:
        raise ValueError("call blr2_lu / blr2_cholesky first")
    if trans not in ("N", "T", "C"):
        raise ValueError("trans must be 'N', 'T' or 'C'")
    rhs = torch.as_tensor(rhs, device=F.device)
    if trans != "N":
        # reductions (factorization.hpp:256-272 trans surface):
        # chol:  A = L̂·L̂ᴴ hermitian  =>  Aᴴ = A ('C'≡'N'); Aᵀ = conj(A), so
        #        x = conj(A⁻¹ conj(b))
        # lu 'C': Aᴴ x = b  <=>  Aᵀ conj(x) = conj(b)
        if F.kind == "chol":
            if trans == "C":
                return blr2_solve(F, rhs, user_numbering, "N")
            return blr2_solve(F, rhs.conj(), user_numbering, "N").conj().resolve_conj()
        if trans == "C":
            return blr2_solve(F, rhs.conj(), user_numbering, "T").conj().resolve_conj()
    rhs, squeeze = _as_rhs(F, rhs)
    if user_numbering:
        rhs = rhs[_index(F.permutation, F.device)]
    b = _panels_pack(F, rhs.to(F.dtype).resolve_conj())

    if F.diag_mode == "dense":
        if F.kind == "chol":
            x = _solve_bwd_chol(F, _solve_fwd_chol(F, b))
        elif trans == "T":
            x = _solve_bwd_lu_trans(F, _solve_fwd_lu_trans(F, b))
        else:
            x = _solve_bwd_lu(F, _solve_fwd_lu(F, b))
    else:
        nC, P, pU, pV = F.nC, F.P, F.pU, F.pV

        def diag_solve(K, r, which, tr="N"):
            sz = int(F.panel_size[K])
            xK = _panel_tri_solve(F.diag[K], r[:sz], which, tr)
            return torch.nn.functional.pad(xK, (0, 0, 0, P - sz)).to(r.dtype)

        y = b.clone()
        if trans == "T" and F.kind == "lu":
            # Aᵀ = Ûᵀ·L̂ᵀ: forward through Ûᵀ (lower), backward through L̂ᵀ
            for K in range(nC):
                r = y[K] - _col_contrib(pU, pV, K, slice(0, K), y) if K else y[K]
                y[K] = diag_solve(K, r, "U", "T")
            for K in range(nC - 1, -1, -1):
                y[K] = diag_solve(K, y[K] - _col_contrib(pU, pV, K, slice(K + 1, nC), y),
                                  "L", "T")
        else:
            # forward: L̂ y = b; panel row K reads pairs (K, J<K) — for
            # Cholesky the lower pairs hold L directly
            for K in range(nC):
                r = y[K] - _row_contrib(pU, pV, K, slice(0, K), y) if K else y[K]
                y[K] = diag_solve(K, r, "L")
            # backward: Û x = y; for Cholesky Û = Lᴴ, row K reads (J>K, K)ᴴ
            for K in range(nC - 1, -1, -1):
                J = slice(K + 1, nC)
                if F.kind == "chol":
                    contrib = _col_contrib(pU, pV, K, J, y, conj=True)
                else:
                    contrib = _row_contrib(pU, pV, K, J, y)
                y[K] = diag_solve(K, y[K] - contrib, "U")
        x = y

    out = _panels_unpack(F, x)
    if user_numbering:
        res = torch.empty_like(out)
        res[_index(F.permutation, F.device)] = out
        out = res
    return out[:, 0] if squeeze else out


# ======================================================================
# products / diagnostics
# ======================================================================


def _offdiag_product(pU, pV, xc, mask=None):
    """y_I = Σ_J U_IJ (V_IJ x_J), optionally over the pairs where ``mask``."""
    t = pU @ (pV @ xc[None])  # [nC, nC, P, k]
    if mask is not None:
        t = t * mask[:, :, None, None].to(t.dtype)
    return t.sum(dim=1)


def blr2_matvec(A: TwoLevelBLR, x):
    """y = A x in cluster numbering (one batched product for the panels,
    one for a dense diagonal, one per panel otherwise); x is cast to the
    matrix's dtype."""
    x, squeeze = _as_rhs(A, x)
    xc = _panels_pack(A, x.to(A.dtype))
    yc = _offdiag_product(A.pU, A.pV, xc)
    if A.diag_mode == "dense":
        yc = yc + A.Dd @ xc
    else:
        for I in range(A.nC):
            sz = int(A.panel_size[I])
            mv = blr2_matvec if isinstance(A.diag[I], TwoLevelBLR) else blr_matvec
            yc[I, :sz] += mv(A.diag[I], xc[I, :sz]).to(yc.dtype)
    out = _panels_unpack(A, yc)
    return out[:, 0] if squeeze else out


def _factor_apply(F: TwoLevelBLR, z):
    """(L̂·Û) z for the backward-error probe (dense-diag LU mode only; other
    modes use the solve-based probe in :func:`blr2_backward_error`)."""
    z, squeeze = _as_rhs(F, z)
    zc = _panels_pack(F, z.to(F.dtype))
    ar = torch.arange(F.nC, device=F.device)
    # w = Û z: strict-upper panels + upper-triangular diag
    w = _offdiag_product(F.pU, F.pV, zc, ar[:, None] < ar[None, :]) + torch.triu(F.Dd) @ zc
    # y = L̂ w: strict-lower panels + P_Kᵀ L_K w (the solve gathers r[perm])
    L = torch.tril(F.Dd, -1) + torch.eye(F.P, dtype=F.dtype, device=F.device)
    Lw = torch.take_along_dim(L @ w, torch.argsort(F.perms, dim=1)[:, :, None], dim=1)
    y = _offdiag_product(F.pU, F.pV, w, ar[:, None] > ar[None, :]) + Lw
    out = _panels_unpack(F, y)
    return out[:, 0] if squeeze else out


def blr2_backward_error(A: TwoLevelBLR, F: TwoLevelBLR, n_probe: int = 4, seed: int = 0):
    """Stochastic backward error ‖(A − L·U)Z‖_F / ‖A·Z‖_F over probes from
    ``np.random.default_rng(seed)`` (the reference's), or — for Cholesky and
    BLR-diagonal factors — ‖A·A_F⁻¹ Z − Z‖_F / ‖Z‖_F."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((A.n, n_probe))
    if A.dtype.is_complex:
        z = z + 1j * rng.standard_normal((A.n, n_probe))
    z = torch.as_tensor(z, device=A.device).to(A.dtype)
    az = blr2_matvec(A, z)
    if F.diag_mode == "dense" and F.kind == "lu":
        num, den = torch.linalg.norm(az - _factor_apply(F, z)), torch.linalg.norm(az)
    else:
        # generic probe: solve then re-apply A — measures ‖A x − z‖/‖z‖
        num = torch.linalg.norm(blr2_matvec(A, blr2_solve(F, z)) - z)
        den = torch.linalg.norm(z)
    den = float(den)
    return float(num) / (den if den != 0 else 1.0)
