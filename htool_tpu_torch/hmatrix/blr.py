"""Block low-rank (BLR) arithmetic: compressed LU and Cholesky, triangular
solves, and compressed×compressed products on a uniform cluster-tree level.

Port of ``htool_tpu/hmatrix/blr.py`` (the reference's recursive H-LU /
H-Cholesky, ``hmatrix/linalg/factorization.hpp:19-205``, triangular solves,
``triangular_hmatrix_hmatrix_solve.hpp:19-198``, and H×H products,
``add_hmatrix_hmatrix_product.hpp:24-312``, on the flat BLR grid of
Amestoy et al.).  Every block is a b×b cell of one tree level, classified
dense / low-rank / zero by the Rjasanow–Steinbach admissibility, and the
right-looking block LU

    for k:  LU(A_kk);  L_ik = A_ik A_kk⁻¹;  A_ij -= L_ik A_kj

runs, per elimination step, as batched torch ops over all cells of a class
at once: ``torch.linalg.lu_factor``/``cholesky`` on the diagonal cell,
``lu_solve``/``solve_triangular`` on the column panel, ``matmul`` for the
Schur contributions, and a batched QR+SVD recompression back to rank ≤
R_half.  The fill-in pattern is data-independent, so a host symbolic pass
(:func:`_facto_schedule`) emits every step's index lists once; they reach the
device in one copy.  The reference's ``lax.scan`` over steps becomes a
Python loop; its pow2 padding of the step tables existed to bound XLA
compiles and is not ported.

Cell tables (``cls``, ``dense_slot``, ``lr_slot``, ``cell_off``,
``cell_size``) are host NumPy; cell data (``D``, ``U``, ``V``, ``ranks``,
``piv``) are tensors on the matrix's device.  ``piv`` holds LAPACK's 1-based
row swaps, as ``torch.linalg.lu_factor`` returns them (the JAX package keeps
0-based ones; :func:`..convert.blr_from_numpy` converts).

Storage invariant: stored LR ranks ≤ R_half; one Schur contribution per
step has rank ≤ R_half; buffers are 2·R_half wide, so appends never
overflow before the end-of-step recompression.
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
from .compressors import batched_recompress, svd_truncation_rank

__all__ = [
    "BLRMatrix",
    "build_blr",
    "blr_lu",
    "blr_cholesky",
    "blr_solve",
    "blr_matvec",
    "blr_matmul",
    "blr_triangular_solve",
    "blr_backward_error",
    "widen_blr",
    "blr_transpose",
    "blr_triangular_solve_matrix",
]

ZERO, DENSE, LR = 0, 1, 2


# ======================================================================
# container
# ======================================================================


@dataclass
class BLRMatrix:
    """Uniform-grid block low-rank matrix (cluster numbering)."""

    n: int  # true matrix size
    cell_off: np.ndarray  # [nL]
    cell_size: np.ndarray  # [nL]
    b: int  # padded cell size
    cls: np.ndarray  # [nL, nL] int8
    dense_slot: np.ndarray  # [nL, nL] int32, -1 if none (last slot = dummy)
    lr_slot: np.ndarray  # [nL, nL] int32
    D: Any  # [nd+1, b, b] (slot nd = zero dummy)
    U: Any  # [nl+1, b, Rbuf]
    V: Any  # [nl+1, Rbuf, b]
    ranks: Any  # [nl+1] int32 on the device
    piv: Any = None  # [nL, b] int32 1-based row swaps of the diagonal LU
    R_half: int = 16
    epsilon: float = 1e-6
    factorized: bool = False
    kind: str = "lu"  # factorization kind once factorized: "lu" | "chol"
    permutation: np.ndarray = None  # cluster -> user
    info: dict = field(default_factory=dict)
    cache: dict = field(default_factory=dict, repr=False)  # plan caches

    @property
    def nL(self) -> int:
        return int(self.cell_off.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.D.dtype

    @property
    def device(self) -> torch.device:
        return self.D.device

    @property
    def R_buf(self) -> int:
        return int(self.U.shape[2])

    # ------------------------------------------------------------------
    def to_dense(self, user_numbering: bool = False) -> np.ndarray:
        nL, b = self.nL, self.b
        D = self.D.cpu().numpy()
        U = self.U.cpu().numpy()
        V = self.V.cpu().numpy()
        rk = self.ranks.cpu().numpy()
        A = np.zeros((nL * b, nL * b), D.dtype)
        for i in range(nL):
            for j in range(nL):
                c = self.cls[i, j]
                if c == ZERO:
                    continue
                if c == DENSE:
                    blk = D[self.dense_slot[i, j]]
                else:
                    s = self.lr_slot[i, j]
                    r = int(rk[s])
                    blk = U[s][:, :r] @ V[s][:r, :]
                A[i * b : (i + 1) * b, j * b : (j + 1) * b] = blk
        # compact padded rows/cols
        keep = np.concatenate([i * b + np.arange(sz) for i, sz in enumerate(self.cell_size)])
        A = A[np.ix_(keep, keep)]
        if user_numbering:
            out = np.zeros_like(A)
            out[np.ix_(self.permutation, self.permutation)] = A
            return out
        return A

    def compression_info(self) -> dict:
        rk = self.ranks.cpu().numpy()
        nd = int((self.cls == DENSE).sum())
        nl = int((self.cls == LR).sum())
        stored = nd * self.b * self.b
        for i, j in zip(*np.nonzero(self.cls == LR)):
            stored += 2 * self.b * int(rk[self.lr_slot[i, j]])
        total = float(self.n) * self.n
        return dict(
            n_dense_cells=nd,
            n_lr_cells=nl,
            n_zero_cells=int((self.cls == ZERO).sum()),
            compression_ratio=total / stored if stored else float("inf"),
            rank_max=int(rk[:-1].max()) if rk.size > 1 else 0,
        )

    def memory_bytes(self) -> int:
        """Bytes of the cell tensors (D, U, V and the pivots)."""
        total = sum(t.numel() * t.element_size() for t in (self.D, self.U, self.V))
        if self.piv is not None:
            total += self.piv.numel() * self.piv.element_size()
        return int(total)


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def _pack(rows: list, device) -> list:
    """Move a list of dicts of host int lists to ``device`` in ONE copy and
    return the same dicts holding int64 views of it."""
    flat, spans, pos = [], [], 0
    for row in rows:
        sp = {}
        for key, v in row.items():
            v = np.asarray(v, np.int64).reshape(-1)
            sp[key] = (pos, v.size)
            flat.append(v)
            pos += v.size
        spans.append(sp)
    dev = _index(np.concatenate(flat) if flat else np.zeros(0, np.int64), device)
    return [{k: dev[a : a + n] for k, (a, n) in sp.items()} for sp in spans]


# ======================================================================
# assembly
# ======================================================================


def _grid_cells(tree: ClusterTree, b_target: int):
    """Pick the deepest level whose cells are all <= b_target, returning
    (node_ids, offsets, sizes) tiling [0, N)."""
    level = 0
    while True:
        cells = []
        ok = True
        stack = [0]
        while stack:
            nd = stack.pop()
            if tree.depths[nd] == level or tree.is_leaf(nd):
                cells.append(nd)
                if tree.sizes[nd] > b_target:
                    ok = False
            else:
                stack.extend(reversed(tree.node_children(nd).tolist()))
        if ok or all(tree.is_leaf(c) for c in cells):  # cannot split further
            break
        level += 1
    cells = sorted(cells, key=lambda nd: tree.offsets[nd])
    offs = np.array([tree.offsets[c] for c in cells], np.int64)
    szs = np.array([tree.sizes[c] for c in cells], np.int64)
    return np.array(cells), offs, szs, level


def build_blr(
    generator: Generator,
    tree: ClusterTree,
    epsilon: float = 1e-6,
    eta: float = 10.0,
    block_size: int = 256,
    R_half: Optional[int] = None,
) -> BLRMatrix:
    """Assemble a BLR matrix on the generator's device: admissible cells by
    one batched partial ACA, the rest by one batched dense gather."""
    cells, offs, szs, level = _grid_cells(tree, block_size)
    nL = len(cells)
    b = max(8, int(-(-int(szs.max()) // 8) * 8))
    N = tree.n_points
    perm = tree.permutation
    dtype, device = generator.dtype, generator.device

    if R_half is None:
        R_half = max(16, min(b // 2, 64))
    R_half = int(-(-R_half // 8) * 8)
    R_buf = 2 * R_half

    # classify cell pairs by admissibility (same rule as the block tree)
    cls = np.zeros((nL, nL), np.int8)
    for i in range(nL):
        for j in range(nL):
            ti, sj = cells[i], cells[j]
            adm = rjasanow_steinbach(
                tree.centers[ti], tree.radii[ti], tree.centers[sj], tree.radii[sj], eta
            )
            cls[i, j] = LR if adm else DENSE

    ar = np.arange(b)[None, :]

    def gather_idx(sel):  # user-numbering indices per cell in sel
        rel = np.minimum(ar, szs[sel][:, None] - 1)
        return perm[offs[sel][:, None] + rel]

    # --- low-rank cells: one batched ACA ---
    lr_pairs = np.argwhere(cls == LR)
    lr_slot = np.full((nL, nL), -1, np.int32)
    if lr_pairs.size:
        Ua, Va, rank, failed = batched_partial_aca(
            generator,
            _index(gather_idx(lr_pairs[:, 0]), device),
            _index(gather_idx(lr_pairs[:, 1]), device),
            _index(szs[lr_pairs[:, 0]], device),
            _index(szs[lr_pairs[:, 1]], device),
            epsilon,
            R_half,
        )
        rank = rank.cpu().numpy()
        failed = failed.cpu().numpy()
        for t, (i, j) in enumerate(lr_pairs):
            if failed[t]:
                cls[i, j] = DENSE
        sel = np.nonzero(~failed)[0]
        nl = sel.size
        U = torch.zeros((nl + 1, b, R_buf), dtype=dtype, device=device)
        V = torch.zeros((nl + 1, R_buf, b), dtype=dtype, device=device)
        sel_d = _index(sel, device)
        U[:nl, :, :R_half] = Ua[sel_d]
        V[:nl, :R_half, :] = Va[sel_d]
        ranks = torch.as_tensor(np.concatenate([rank[sel], [0]]).astype(np.int32), device=device)
        for t_new, t_old in enumerate(sel):
            i, j = lr_pairs[t_old]
            lr_slot[i, j] = t_new
        del Ua, Va
    else:
        U = torch.zeros((1, b, R_buf), dtype=dtype, device=device)
        V = torch.zeros((1, R_buf, b), dtype=dtype, device=device)
        ranks = torch.zeros((1,), dtype=torch.int32, device=device)

    # --- dense cells: one batched gather ---
    dn_pairs = np.argwhere(cls == DENSE)
    dense_slot = np.full((nL, nL), -1, np.int32)
    nd = dn_pairs.shape[0]
    D = torch.zeros((nd + 1, b, b), dtype=dtype, device=device)
    if nd:
        D[:nd] = generator.block(_index(gather_idx(dn_pairs[:, 0]), device),
                                 _index(gather_idx(dn_pairs[:, 1]), device))
        rmask = _index(ar, device) < _index(szs[dn_pairs[:, 0]], device)[:, None]
        cmask = _index(ar, device) < _index(szs[dn_pairs[:, 1]], device)[:, None]
        D[:nd].masked_fill_(~(rmask[:, :, None] & cmask[:, None, :]), 0)
        dense_slot[dn_pairs[:, 0], dn_pairs[:, 1]] = np.arange(nd)

    # identity on diagonal padding so diagonal cells stay invertible
    for i in range(nL):
        s = dense_slot[i, i]
        if s >= 0 and szs[i] < b:
            D[s].diagonal()[int(szs[i]) :] += 1

    return BLRMatrix(
        n=N,
        cell_off=offs,
        cell_size=szs,
        b=b,
        cls=cls,
        dense_slot=dense_slot,
        lr_slot=lr_slot,
        D=D,
        U=U,
        V=V,
        ranks=ranks,
        R_half=R_half,
        epsilon=epsilon,
        permutation=perm,
        info=dict(level=level, n_cells=nL),
    )


# ======================================================================
# batched step operations
# ======================================================================


def _lu_solve_trans(LU, piv, B, trans: int):
    """op(A) X = B from A's LU factors: trans 0 (N), 1 (plain transpose) or
    2 (conjugate transpose).  ``lu_solve(adjoint=True)`` is Aᴴ, so the plain
    transpose of a complex A runs as conj(A⁻ᴴ conj(B))."""
    if trans == 0:
        return torch.linalg.lu_solve(LU, piv, B)
    if trans == 1 and LU.is_complex():
        return torch.linalg.lu_solve(LU, piv, B.conj(), adjoint=True).conj()
    return torch.linalg.lu_solve(LU, piv, B, adjoint=True)


def _tri_solve_trans(T, B, lower: bool, trans: int, unit: bool = False):
    """op(T) X = B for a triangular T (only its ``lower``/upper triangle is
    read): ``solve_triangular`` has no trans argument, so op(T) is formed
    and the triangle flips."""
    if trans == 0:
        return torch.linalg.solve_triangular(T, B, upper=not lower, unitriangular=unit)
    op = T.mT if trans == 1 else T.mH
    return torch.linalg.solve_triangular(op, B, upper=lower, unitriangular=unit)


def _operand(ops, a, lr, Rh, herm=False):
    """The cells at slots ``a`` of ``ops`` = (D, U, V): dense blocks, or the
    (U, V) factors when ``lr``; ``herm`` applies them conj-transposed
    (Dᴴ, or the factors Vᴴ, Uᴴ)."""
    D, U, V = ops
    if not lr:
        return D[a].mH if herm else D[a]
    if herm:
        return V[a][:, :Rh, :].mH, U[a][:, :, :Rh].mH
    return U[a][:, :, :Rh], V[a][:, :Rh, :]


def _group(g: dict) -> dict:
    """Split one Schur target group's rows by operand classes:
    {"dd"|"dl"|"ld"|"ll": (a slots, b slots, targets)}."""
    out: dict = {}
    names = {(DENSE, DENSE): "dd", (DENSE, LR): "dl", (LR, DENSE): "ld", (LR, LR): "ll"}
    for ac, a, bc, b, t in zip(g["ac"], g["a"], g["bc"], g["b"], g["t"]):
        rows = out.setdefault(names[(int(ac), int(bc))], ([], [], []))
        rows[0].append(a)
        rows[1].append(b)
        rows[2].append(t)
    return out


def _flat_groups(g: dict, prefix: str) -> dict:
    """A step's Schur group as flat keys for :func:`_pack`."""
    out = {}
    for combo, (a, b, t) in _group(g).items():
        out[f"{prefix}{combo}_a"], out[f"{prefix}{combo}_b"], out[f"{prefix}{combo}_t"] = a, b, t
    return out


# bytes of operand gathers and products per batch of Schur rows: a step's
# rows are cut into batches of about this size
_STEP_BYTES = 1 << 30


def _batches(tab, prefix, combo, Dt):
    """The (a slots, b slots, targets) of one combination's Schur rows in
    batches of about :data:`_STEP_BYTES` (three b×b cells a row)."""
    t = tab.get(f"{prefix}{combo}_t")
    if t is None:
        return
    a, b = tab[f"{prefix}{combo}_a"], tab[f"{prefix}{combo}_b"]
    cell = Dt.shape[-1] * Dt.shape[-1] * Dt.element_size()
    step = max(1, _STEP_BYTES // (3 * cell))
    for lo in range(0, t.numel(), step):
        yield a[lo : lo + step], b[lo : lo + step], t[lo : lo + step]


def _schur_dense(Dt, A_ops, B_ops, tab, prefix, Rh, herm_b=False, neg=True):
    """Dt[t] (-)= A_ik B_kj into dense targets, every class combination.
    ``A_ops``/``B_ops``: the left/right operands' (D, U, V); with ``herm_b``
    the right operand is applied conj-transposed (the Cholesky Schur update
    A_ij -= L_ik L_jkᴴ, factorization.hpp:131-205)."""
    for combo in ("dd", "dl", "ld", "ll"):
        for a, b, t in _batches(tab, prefix, combo, Dt):
            La = _operand(A_ops, a, combo[0] == "l", Rh)
            Rb = _operand(B_ops, b, combo[1] == "l", Rh, herm_b)
            if combo == "dd":
                c = La @ Rb
            elif combo == "dl":
                c = (La @ Rb[0]) @ Rb[1]
            elif combo == "ld":
                c = La[0] @ (La[1] @ Rb)
            else:
                c = La[0] @ ((La[1] @ Rb[0]) @ Rb[1])
            Dt.index_add_(0, t, c.to(Dt.dtype), alpha=-1 if neg else 1)


def _schur_lr(Ut, Vt, ranks_t, A_ops, ranks_a, B_ops, ranks_b, tab, prefix, Rh,
              herm_b=False, neg=True):
    """Ut·Vt at t (-)= A_ik B_kj appended as factor pairs (at least one side
    low rank) at column offset ranks_t[t]; ranks_t grows by the
    contribution's rank (the invariant keeps the append inside 2·R_half)."""
    Rbuf = Ut.shape[2]
    ar = torch.arange(Rh, device=Ut.device)
    for combo in ("dl", "ld", "ll"):
        for a, b, t in _batches(tab, prefix, combo, A_ops[0]):
            La = _operand(A_ops, a, combo[0] == "l", Rh)
            Rb = _operand(B_ops, b, combo[1] == "l", Rh, herm_b)
            if combo == "dl":
                Uc, Vc, rc = La @ Rb[0], Rb[1], ranks_b[b]
            elif combo == "ld":
                Uc, Vc, rc = La[0], La[1] @ Rb, ranks_a[a]
            else:
                Uc, Vc, rc = La[0], (La[1] @ Rb[0]) @ Rb[1], torch.minimum(ranks_a[a], ranks_b[b])
            off = ranks_t[t].long()
            cols = off[:, None] + ar  # [c, Rh]
            Ug, Vg = Ut[t], Vt[t]
            Ug.scatter_(2, cols[:, None, :].expand(-1, Ug.shape[1], -1),
                        (-Uc if neg else Uc).to(Ug.dtype))
            Vg.scatter_(1, cols[:, :, None].expand(-1, -1, Vg.shape[2]), Vc.to(Vg.dtype))
            Ut[t], Vt[t] = Ug, Vg
            ranks_t[t] = torch.clamp(off + rc, max=Rbuf).to(ranks_t.dtype)


def _recompress(U, V, ranks, slots, epsilon, Rh, capped=None):
    """Batched epsilon-truncation of the touched LR cells, capped at R_half.

    ``capped`` (optional [n_lr] int32) accumulates, per cell, whether the
    epsilon-rank EXCEEDED the cap — the silent-accuracy-loss detector behind
    the factorization's backward-error guard."""
    U2, V2, r2 = batched_recompress(U[slots], V[slots], ranks[slots], epsilon)
    hit = r2 > Rh
    r2 = torch.clamp(r2, max=Rh)
    keep = torch.arange(U.shape[2], device=U.device)[None, :] < r2[:, None]
    U[slots] = U2 * keep[:, None, :].to(U.dtype)
    V[slots] = V2 * keep[:, :, None].to(V.dtype)
    ranks[slots] = r2.to(ranks.dtype)
    if capped is not None:
        capped[slots] = torch.maximum(capped[slots], hit.to(capped.dtype))


# ======================================================================
# factorization — host schedule, device loop over elimination steps
# ======================================================================


def _facto_schedule(A: BLRMatrix, kind: str):
    """Host symbolic pass for the factorization: simulate the fill-in /
    class-upgrade evolution once (data-independent) and emit, per
    elimination step, the index lists of every device phase — the planning
    role of the reference's task-dependency pass (``task_dependencies.hpp``)
    for its recursive H-LU (``factorization.hpp:19-79`` LU, ``:131-205``
    Cholesky)."""
    nL = A.nL
    herm = kind == "chol"
    cls = A.cls.copy()
    if herm:
        for i in range(nL):
            for j in range(i + 1, nL):
                cls[i, j] = ZERO  # upper triangle unused
    densify_at, fill_lr_at, fill_dn_at = {}, {}, {}
    for k in range(nL):
        assert cls[k, k] == DENSE, "diagonal cells must be dense"
        for i in range(k + 1, nL):
            if cls[i, k] == ZERO:
                continue
            js = range(k + 1, i + 1) if herm else range(k + 1, nL)
            for j in js:
                ck2 = cls[j, k] if herm else cls[k, j]
                if ck2 == ZERO:
                    continue
                contrib = DENSE if (cls[i, k] == DENSE and ck2 == DENSE) else LR
                if cls[i, j] == ZERO:
                    cls[i, j] = contrib
                    (fill_dn_at if contrib == DENSE else fill_lr_at)[(i, j)] = k
                elif cls[i, j] == LR and contrib == DENSE:
                    cls[i, j] = DENSE
                    densify_at[(i, j)] = k

    # final slot allocation (every ever-dense cell gets a dense slot)
    dense_slot = A.dense_slot.copy()
    lr_slot = A.lr_slot.copy()
    nd = int(A.D.shape[0]) - 1
    nl = int(A.U.shape[0]) - 1
    for (i, j) in sorted(list(densify_at) + list(fill_dn_at)):
        if dense_slot[i, j] < 0:
            dense_slot[i, j] = nd
            nd += 1
    for (i, j) in sorted(fill_lr_at):
        if lr_slot[i, j] < 0:
            lr_slot[i, j] = nl
            nl += 1

    # re-simulate step by step, emitting phase lists
    cls2 = A.cls.copy()
    if herm:
        for i in range(nL):
            for j in range(i + 1, nL):
                cls2[i, j] = ZERO
    steps = []
    for k in range(nL):
        st = {"k": k, "ds": int(dense_slot[k, k])}
        st["cd"] = [int(dense_slot[i, k]) for i in range(k + 1, nL) if cls2[i, k] == DENSE]
        st["cl"] = [int(lr_slot[i, k]) for i in range(k + 1, nL) if cls2[i, k] == LR]
        dens = sorted((i, j) for (i, j), kk in densify_at.items() if kk == k)
        st["dfd"] = [int(dense_slot[i, j]) for i, j in dens]
        st["dfl"] = [int(lr_slot[i, j]) for i, j in dens]
        for i, j in dens:
            cls2[i, j] = DENSE
        for (i, j), kk in fill_dn_at.items():
            if kk == k:
                cls2[i, j] = DENSE
        for (i, j), kk in fill_lr_at.items():
            if kk == k:
                cls2[i, j] = LR

        sd = {key: [] for key in ("ac", "a", "bc", "b", "t")}
        sl = {key: [] for key in ("ac", "a", "bc", "b", "t")}
        touched = []
        for i in range(k + 1, nL):
            cik = cls2[i, k]
            if cik == ZERO:
                continue
            ia = int(dense_slot[i, k] if cik == DENSE else lr_slot[i, k])
            js = range(k + 1, i + 1) if herm else range(k + 1, nL)
            for j in js:
                cjk = cls2[j, k] if herm else cls2[k, j]
                if cjk == ZERO:
                    continue
                if herm:
                    jb = int(dense_slot[j, k] if cjk == DENSE else lr_slot[j, k])
                else:
                    jb = int(dense_slot[k, j] if cjk == DENSE else lr_slot[k, j])
                if cls2[i, j] == DENSE:
                    g = sd
                    g["t"].append(int(dense_slot[i, j]))
                else:
                    g = sl
                    g["t"].append(int(lr_slot[i, j]))
                    touched.append(int(lr_slot[i, j]))
                g["ac"].append(int(cik))
                g["a"].append(ia)
                g["bc"].append(int(cjk))
                g["b"].append(jb)
        st["sd"] = sd
        st["sl"] = sl
        st["rc"] = sorted(set(touched))
        steps.append(st)
    return steps, cls, dense_slot, lr_slot, nd, nl


def _step_tables(steps, device) -> list:
    """Every step's index lists on the device (one copy), Schur rows split
    by operand classes; empty lists are left out."""
    rows = []
    for st in steps:
        row = {key: st[key] for key in ("cd", "cl", "dfd", "dfl", "rc") if st[key]}
        row.update(_flat_groups(st["sd"], "sd_"))
        row.update(_flat_groups(st["sl"], "sl_"))
        rows.append(row)
    return _pack(rows, device)


def _factorize(A: BLRMatrix, eps: float, kind: str,
               auto_escalate: int, error_estimate: bool) -> BLRMatrix:
    """Shared driver for :func:`blr_lu` / :func:`blr_cholesky`: one pass of
    batched torch ops per elimination step over the host schedule."""
    nL, b, Rh = A.nL, A.b, A.R_half
    device, dtype = A.device, A.dtype
    herm = kind == "chol"
    t0 = time.perf_counter()
    steps, cls, dense_slot, lr_slot, nd, nl = _facto_schedule(A, kind)
    tabs = _step_tables(steps, device)

    def grown(X, count, shape):
        return torch.cat([X[:-1], torch.zeros((count - (X.shape[0] - 1) + 1, *shape),
                                              dtype=X.dtype, device=device)])

    D = grown(A.D, nd, (b, b))
    U = grown(A.U, nl, (b, A.R_buf))
    V = grown(A.V, nl, (A.R_buf, b))
    ranks = grown(A.ranks, nl, ())
    piv_all = torch.ones((nL, b), dtype=torch.int32, device=device)
    capped = torch.zeros((U.shape[0],), dtype=torch.int32, device=device)
    ops = (D, U, V)

    for st, tab in zip(steps, tabs):
        ds, k = st["ds"], st["k"]
        if herm:
            D[ds] = torch.linalg.cholesky_ex(D[ds])[0]
        else:
            D[ds], piv_all[k] = torch.linalg.lu_factor_ex(D[ds])[:2]
        diag = D[ds]
        cd, cl = tab.get("cd"), tab.get("cl")
        # column panels: L_ik = A_ik A_kk⁻¹ (LU) or A_ik L_kk⁻ᴴ (Cholesky);
        # an LR cell transforms its V
        for X, slots in ((D, cd), (V, cl)):
            if slots is None:
                continue
            if herm:
                X[slots] = torch.linalg.solve_triangular(diag.mH, X[slots], upper=True,
                                                         left=False)
            else:
                B = X[slots]
                X[slots] = torch.linalg.lu_solve(diag.expand(B.shape[0], b, b),
                                                 piv_all[k].expand(B.shape[0], b), B,
                                                 left=False)
        if "dfd" in tab:  # class upgrades: materialize LR cells densely
            D[tab["dfd"]] = U[tab["dfl"]] @ V[tab["dfl"]]
        _schur_dense(D, ops, ops, tab, "sd_", Rh, herm_b=herm)
        _schur_lr(U, V, ranks, ops, ranks, ops, ranks, tab, "sl_", Rh, herm_b=herm)
        if "rc" in tab:
            _recompress(U, V, ranks, tab["rc"], eps, Rh, capped)

    out = BLRMatrix(
        n=A.n,
        cell_off=A.cell_off,
        cell_size=A.cell_size,
        b=b,
        cls=cls,
        dense_slot=dense_slot,
        lr_slot=lr_slot,
        D=D,
        U=U,
        V=V,
        ranks=ranks,
        piv=None if herm else piv_all,
        R_half=Rh,
        epsilon=eps,
        factorized=True,
        kind=kind,
        permutation=A.permutation,
        info=dict(A.info),
    )
    n_capped = int(capped[:nl].sum())  # the one read of the device per factorization
    out.info[f"{'cholesky' if herm else 'lu'}_walltime"] = time.perf_counter() - t0
    out.info["n_rank_capped_cells"] = n_capped
    out.info["R_half"] = Rh
    if n_capped > 0 and auto_escalate > 0:
        redo = blr_cholesky if herm else blr_lu
        return redo(widen_blr(A, 2 * Rh), eps, auto_escalate - 1, error_estimate)
    if error_estimate:
        out.info["backward_error_est"] = blr_backward_error(A, out, n_probe=2)
    return out


def blr_lu(A: BLRMatrix, epsilon: Optional[float] = None,
           auto_escalate: int = 1, error_estimate: bool = True) -> BLRMatrix:
    """Right-looking BLR LU (the H-LU equivalent, factorization.hpp:19-79).

    Returns a new factorized BLRMatrix: diagonal cells hold their pivoted LU
    factors, subdiagonal cells hold L_ik = A_ik A_kk⁻¹, superdiagonal cells
    hold the updated U_kj = A_kj.

    Accuracy guard: cells whose epsilon-rank exceeds the R_half cap during
    the Schur recompressions are counted (``info['n_rank_capped_cells']``);
    with ``auto_escalate`` > 0 the factorization re-runs with doubled
    R_half buffers until no cell is capped (or the budget is spent).  With
    ``error_estimate`` a stochastic backward error ‖(A − LU)Z‖/‖AZ‖ is
    reported in ``info['backward_error_est']``."""
    eps = A.epsilon if epsilon is None else epsilon
    return _factorize(A, eps, "lu", auto_escalate, error_estimate)


def blr_cholesky(A: BLRMatrix, epsilon: Optional[float] = None,
                 auto_escalate: int = 1, error_estimate: bool = True) -> BLRMatrix:
    """Right-looking BLR Cholesky A = L·Lᴴ — the H-Cholesky equivalent
    (``factorization.hpp:131-205``): per step k factor the diagonal cell
    (potrf), transform the subdiagonal column panel L_ik = A_ik L_kk⁻ᴴ,
    then Schur-update the trailing LOWER triangle A_ij -= L_ik L_jkᴴ.

    Only the lower triangle of ``A`` is read (real symmetric or complex
    hermitian positive definite, matching LAPACK potrf); the returned matrix
    stores L in the lower triangle and zeros the upper class map."""
    eps = A.epsilon if epsilon is None else epsilon
    return _factorize(A, eps, "chol", auto_escalate, error_estimate)


# ======================================================================
# solve and products
# ======================================================================


def _sweep_tables(F: BLRMatrix, which: str, trans: str):
    """Host-side plan for one block-triangular sweep over factor ``which``
    ('L' strict lower + diag, 'U' strict upper + diag) applied as
    ``op(T, trans)``.  Returns numpy (order, dsl, dj, lsl, lj, dgs) where
    padded entries point at the zero dummy slots.  Cached on F.cache."""
    key = ("_sweep", which, trans != "N")
    cached = F.cache.get(key)
    if cached is not None:
        return cached
    nL = F.nL
    lower = which == "L"
    fwd = lower == (trans == "N")
    order = list(range(nL)) if fwd else list(range(nL - 1, -1, -1))
    DUMMY_D = int(F.D.shape[0]) - 1
    DUMMY_L = int(F.U.shape[0]) - 1
    rows = []
    for i in order:
        ds, djs, ls, ljs = [], [], [], []
        if trans == "N":
            rng = range(i) if lower else range(i + 1, nL)
            for j in rng:
                c = F.cls[i, j]
                if c == DENSE:
                    ds.append(int(F.dense_slot[i, j])); djs.append(j)
                elif c == LR:
                    ls.append(int(F.lr_slot[i, j])); ljs.append(j)
        else:
            # op(T) row i uses cells (j, i) of T, applied transposed
            rng = range(i + 1, nL) if lower else range(i)
            for j in rng:
                c = F.cls[j, i]
                if c == DENSE:
                    ds.append(int(F.dense_slot[j, i])); djs.append(j)
                elif c == LR:
                    ls.append(int(F.lr_slot[j, i])); ljs.append(j)
        rows.append((ds, djs, ls, ljs))
    Wd = max(1, max(len(r[0]) for r in rows))
    Wl = max(1, max(len(r[2]) for r in rows))
    dsl = np.full((nL, Wd), DUMMY_D, np.int32)
    dj = np.zeros((nL, Wd), np.int32)
    lsl = np.full((nL, Wl), DUMMY_L, np.int32)
    lj = np.zeros((nL, Wl), np.int32)
    for t, (ds, djs, ls, ljs) in enumerate(rows):
        dsl[t, : len(ds)] = ds
        dj[t, : len(djs)] = djs
        lsl[t, : len(ls)] = ls
        lj[t, : len(ljs)] = ljs
    dgs = np.array([int(F.dense_slot[i, i]) for i in order], np.int32)
    plan = (np.asarray(order, np.int32), dsl, dj, lsl, lj, dgs)
    F.cache[key] = plan
    return plan


def _sweep_rows(F: BLRMatrix, which: str, trans: str) -> list:
    """:func:`_sweep_tables` without its padding, per visited row, on the
    device: (row, diag slot, dense slots, their rows, LR slots, their rows)."""
    key = ("_sweep_dev", which, trans != "N")
    rows = F.cache.get(key)
    if rows is None:
        order, dsl, dj, lsl, lj, dgs = _sweep_tables(F, which, trans)
        DUMMY_D, DUMMY_L = int(F.D.shape[0]) - 1, int(F.U.shape[0]) - 1
        host = []
        for t in range(len(order)):
            nd, nl = int((dsl[t] != DUMMY_D).sum()), int((lsl[t] != DUMMY_L).sum())
            host.append(dict(ds=dsl[t, :nd], dj=dj[t, :nd], ls=lsl[t, :nl], lj=lj[t, :nl]))
        dev = _pack(host, F.device)
        rows = [(int(order[t]), int(dgs[t]), d["ds"], d["dj"], d["ls"], d["lj"])
                for t, d in enumerate(dev)]
        F.cache[key] = rows
    return rows


_DIAG_TRANS = {"": 0, "_t": 1, "_c": 2}


def _run_sweep(F: BLRMatrix, y, which: str, trans: str, diag: str, conj_cells: bool = False):
    """Block-triangular sweep over the rows of ``y`` [nL, b, k] (in place):
    per visited row, subtract the products of its off-diagonal cells with
    the rows already solved, then apply the diagonal operation — the
    reference's scanned sweep (``_k_block_sweep``, the level-scheduled
    replacement of triangular_hmatrix_matrix_solve.hpp:18,114).

    diag: 'none' (unit block diagonal), 'lu'/'lu_t'/'lu_c' (factored diag
    cell + pivots), 'lo'/'lo_t'/'lo_c' and 'up'/'up_t'/'up_c' (triangular
    diag cell, optional (conj-)transpose)."""
    t_cells = trans != "N"
    c_cells = conj_cells or trans == "C"
    Rh = F.R_half
    kind, tr = diag[:2], _DIAG_TRANS[diag[2:]] if diag != "none" else 0
    for i, dg, ds, dj, ls, lj in _sweep_rows(F, which, trans):
        r = y[i]
        if ds.numel():
            Dw = F.D[ds].to(y.dtype)
            if c_cells:
                Dw = Dw.conj()
            Dw = Dw.mT if t_cells else Dw
            r = r - torch.einsum("wij,wjk->ik", Dw, y[dj])
        if ls.numel():
            Uw = F.U[ls][:, :, :Rh].to(y.dtype)
            Vw = F.V[ls][:, :Rh, :].to(y.dtype)
            if c_cells:
                Uw, Vw = Uw.conj(), Vw.conj()
            if t_cells:  # (U V)ᵀ = Vᵀ Uᵀ
                Uw, Vw = Vw.mT, Uw.mT
            r = r - torch.einsum("wir,wrk->ik", Uw, Vw @ y[lj])
        if diag == "none":
            xi = r
        else:
            dgD = F.D[dg].to(y.dtype)
            if kind == "lu":
                xi = _lu_solve_trans(dgD, F.piv[i], r, tr)
            else:
                xi = _tri_solve_trans(dgD, r, kind == "lo", tr)
        y[i] = xi
    return y


def _cells_plan(F: BLRMatrix):
    """Pad/compact index maps for cell layout <-> flat vectors (cached)."""
    plan = F.cache.get("_cells")
    if plan is None:
        ar = np.arange(F.b)[None, :]
        pad_idx = np.minimum(F.cell_off[:, None] + ar, F.n - 1)
        mask = ar < F.cell_size[:, None]
        keep = np.concatenate([i * F.b + np.arange(sz) for i, sz in enumerate(F.cell_size)])
        plan = (_index(pad_idx, F.device), torch.as_tensor(mask, device=F.device),
                _index(keep, F.device))
        F.cache["_cells"] = plan
    return plan


def _to_cells(F: BLRMatrix, x, dtype):
    pad_idx, mask, _ = _cells_plan(F)
    return torch.where(mask[:, :, None], x[pad_idx].to(dtype), 0)


def _from_cells(F: BLRMatrix, yc):
    _, _, keep = _cells_plan(F)
    return yc.reshape(F.nL * F.b, yc.shape[-1])[keep]


def _as_rhs(F: BLRMatrix, x):
    """``x`` as a tensor on F's device, and whether it was one vector."""
    x = torch.as_tensor(x, device=F.device)
    squeeze = x.ndim == 1
    return (x[:, None] if squeeze else x), squeeze


def blr_solve(F: BLRMatrix, rhs, user_numbering: bool = False, trans: str = "N"):
    """Solve op(A) x = rhs with a factorized BLR matrix — the lu_solve /
    cholesky_solve equivalent (factorization.hpp:119-128,245-273) with the
    reference's trans ∈ {'N','T','C'} surface.

    LU stores A = L̂·Û with unit-block-diagonal L̂ and factored diagonal
    cells in Û; Cholesky stores A = L·Lᴴ.  Each sweep visits the block rows
    once (:func:`_run_sweep`)."""
    if not F.factorized:
        raise ValueError("matrix is not factorized; call blr_lu first")
    rhs, squeeze = _as_rhs(F, rhs)
    if user_numbering:
        rhs = rhs[_index(F.permutation, F.device)]
    dtype = torch.promote_types(F.dtype, rhs.dtype)
    y = _to_cells(F, rhs, dtype)

    if F.kind == "chol":
        if trans == "T":
            # Aᵀ = conj(A) for hermitian A: solve via global conj trick
            y = y.conj().resolve_conj()
        y = _run_sweep(F, y, "L", "N", "lo")
        y = _run_sweep(F, y, "L", "C", "lo_c")
        if trans == "T":
            y = y.conj().resolve_conj()
    elif trans == "N":
        y = _run_sweep(F, y, "L", "N", "none")
        y = _run_sweep(F, y, "U", "N", "lu")
    else:
        # op(A) = op(Û)·op(L̂): sweep Ûᵀ/ᴴ first, then L̂ᵀ/ᴴ
        y = _run_sweep(F, y, "U", trans, "lu_t" if trans == "T" else "lu_c")
        y = _run_sweep(F, y, "L", trans, "none")

    out = _from_cells(F, y)
    if user_numbering:
        res = torch.empty_like(out)
        res[_index(F.permutation, F.device)] = out
        out = res
    return out[:, 0] if squeeze else out


def blr_triangular_solve(F: BLRMatrix, B, which: str = "L", side: str = "L",
                         trans: str = "N"):
    """Standalone block-triangular solve with one factor of a BLR matrix:
    ``op(T)·X = B`` (side 'L') or ``X·op(T) = B`` (side 'R'), where T is the
    L or U factor of a factorized BLR matrix, or the (lower/upper) triangle
    of an unfactorized triangular BLR matrix.

    The reference surface this matches: triangular_hmatrix_matrix_solve.hpp:
    18 (side 'L'), :114 (side 'R'), with transa ∈ {'N','T','C'}.  ``B`` may
    also be a ``(Ub, Vb)`` low-rank factor pair (the
    triangular_hmatrix_lrmat_solve.hpp variant): side 'L' solves on the U
    factor, side 'R' on the V factor, returning a new pair."""
    if which not in ("L", "U"):
        raise ValueError("which must be 'L' or 'U'")
    if isinstance(B, tuple):
        Ub, Vb = B
        if side == "L":
            return blr_triangular_solve(F, Ub, which, "L", trans), Vb
        return Ub, blr_triangular_solve(F, Vb, which, "R", trans)

    B = torch.as_tensor(B, device=F.device)
    if side == "R":
        # X op(T) = B  <=>  op(T)ᵀ Xᵀ = Bᵀ ; 'C' via the conj trick
        if trans == "C":
            return blr_triangular_solve(F, B.conj().T, which, "L", "N").conj().T.resolve_conj()
        flipped = "T" if trans == "N" else "N"
        return blr_triangular_solve(F, B.T, which, "L", flipped).T

    B, squeeze = _as_rhs(F, B)
    y = _to_cells(F, B, torch.promote_types(F.dtype, B.dtype))

    if F.factorized and F.kind == "chol":
        if which == "L":
            y = _run_sweep(F, y, "L", trans, {"N": "lo", "T": "lo_t", "C": "lo_c"}[trans])
        elif trans == "N":  # 'U' factor of a Cholesky factorization is Lᴴ
            y = _run_sweep(F, y, "L", "C", "lo_c")
        elif trans == "C":  # (Lᴴ)ᴴ = L
            y = _run_sweep(F, y, "L", "N", "lo")
        else:  # (Lᴴ)ᵀ = conj(L): conj trick
            y = _run_sweep(F, y.conj().resolve_conj(), "L", "N", "lo").conj().resolve_conj()
    elif F.factorized:
        d = "none" if which == "L" else {"N": "lu", "T": "lu_t", "C": "lu_c"}[trans]
        y = _run_sweep(F, y, which, trans, d)
    else:
        # unfactorized triangular BLR matrix: diag cells are triangular
        base = "lo" if which == "L" else "up"
        d = base if trans == "N" else base + ("_t" if trans == "T" else "_c")
        y = _run_sweep(F, y, which, trans, d)

    out = _from_cells(F, y)
    return out[:, 0] if squeeze else out


def _cells_product(F: BLRMatrix, xc, tabs, adjoint=False):
    """Σ over the cells of ``tabs`` (rows, cols, slots of dense and of LR
    cells) of cell · x_col, added into its row — or, with ``adjoint``,
    cellᴴ · x_row added into its column: batched products and index adds,
    in batches of about :data:`_STEP_BYTES` of gathered cells."""
    d_i, d_j, d_slot, l_i, l_j, l_slot = tabs
    if adjoint:
        d_i, d_j, l_i, l_j = d_j, d_i, l_j, l_i
    Rh, b = F.R_half, F.b
    yc = torch.zeros_like(xc)
    step = max(1, _STEP_BYTES // (b * b * xc.element_size()))
    for lo in range(0, d_i.numel(), step):
        sl = slice(lo, lo + step)
        D = F.D[d_slot[sl]].to(xc.dtype)
        yc.index_add_(0, d_i[sl], (D.mH if adjoint else D) @ xc[d_j[sl]])
    step = max(1, _STEP_BYTES // (4 * b * Rh * xc.element_size()))
    for lo in range(0, l_i.numel(), step):
        sl = slice(lo, lo + step)
        U = F.U[l_slot[sl]][:, :, :Rh].to(xc.dtype)
        V = F.V[l_slot[sl]][:, :Rh, :].to(xc.dtype)
        if adjoint:
            U, V = V.mH, U.mH
        yc.index_add_(0, l_i[sl], U @ (V @ xc[l_j[sl]]))
    return yc


def _cells_tables(F: BLRMatrix, which: str):
    """(rows, cols, slots) of the dense and the LR cells: all of them
    (``which`` 'A'), or the strict lower ('L', j < i) / upper ('U') ones.
    Cached on the device."""
    key = ("_cellsmv", which)
    tabs = F.cache.get(key)
    if tabs is None:
        i, j = np.indices(F.cls.shape)
        tri = {"A": np.ones_like(F.cls, bool), "L": j < i, "U": j > i}[which]
        di, dj = np.nonzero((F.cls == DENSE) & tri)
        li, lj = np.nonzero((F.cls == LR) & tri)
        host = dict(di=di, dj=dj, ds=F.dense_slot[di, dj], li=li, lj=lj, ls=F.lr_slot[li, lj])
        dev = _pack([host], F.device)[0]
        tabs = tuple(dev[k] for k in ("di", "dj", "ds", "li", "lj", "ls"))
        F.cache[key] = tabs
    return tabs


def blr_matvec(A: BLRMatrix, x):
    """y = A x in cluster numbering: one batched product per cell class."""
    x, squeeze = _as_rhs(A, x)
    xc = _to_cells(A, x, torch.promote_types(A.dtype, x.dtype))
    out = _from_cells(A, _cells_product(A, xc, _cells_tables(A, "A")))
    return out[:, 0] if squeeze else out


def blr_matmul(A: BLRMatrix, B: BLRMatrix, epsilon: Optional[float] = None) -> BLRMatrix:
    """C = A·B in BLR form — the compressed×compressed product
    (internal_add_hmatrix_hmatrix_product, add_hmatrix_hmatrix_product.hpp:
    24-312) with truncated low-rank accumulation.

    Operands on different grids are re-tiled onto a common grid first (the
    flat-layout equivalent of the reference's inconsistent-tree recursion,
    add_hmatrix_hmatrix_product.hpp:31-74)."""
    if A.nL != B.nL or A.b != B.b or not np.array_equal(A.cell_off, B.cell_off):
        from .conversion import common_grid_blr

        A, B = common_grid_blr(A, B)
    eps = A.epsilon if epsilon is None else epsilon
    nL, b, Rh = A.nL, A.b, max(A.R_half, B.R_half)

    # symbolic: C classification
    clsC = np.zeros((nL, nL), np.int8)
    for i in range(nL):
        for j in range(nL):
            for k in range(nL):
                a, c = A.cls[i, k], B.cls[k, j]
                if a == ZERO or c == ZERO:
                    continue
                contrib = DENSE if (a == DENSE and c == DENSE) else LR
                if clsC[i, j] == ZERO:
                    clsC[i, j] = contrib
                elif contrib == DENSE:
                    clsC[i, j] = DENSE

    dense_slot = np.full((nL, nL), -1, np.int32)
    lr_slot = np.full((nL, nL), -1, np.int32)
    nd = nl = 0
    for i in range(nL):
        for j in range(nL):
            if clsC[i, j] == DENSE:
                dense_slot[i, j] = nd
                nd += 1
            elif clsC[i, j] == LR:
                lr_slot[i, j] = nl
                nl += 1
    dtype = torch.promote_types(A.dtype, B.dtype)
    dev = A.device
    C = BLRMatrix(
        n=A.n,
        cell_off=A.cell_off,
        cell_size=A.cell_size,
        b=b,
        cls=clsC,
        dense_slot=dense_slot,
        lr_slot=lr_slot,
        D=torch.zeros((nd + 1, b, b), dtype=dtype, device=dev),
        U=torch.zeros((nl + 1, b, 2 * Rh), dtype=dtype, device=dev),
        V=torch.zeros((nl + 1, 2 * Rh, b), dtype=dtype, device=dev),
        ranks=torch.zeros((nl + 1,), dtype=torch.int32, device=dev),
        R_half=Rh,
        epsilon=eps,
        permutation=A.permutation,
    )
    return _blr_matmul_batched(A, B, C, eps)


def _widen_lr(M: BLRMatrix, Rh: int):
    """(D, U, V) of M with LR buffers padded to width >= Rh so the shared
    Schur operations can slice [:Rh] on either operand."""
    if M.U.shape[2] >= Rh:
        return M.D, M.U, M.V
    w = Rh - M.U.shape[2]
    return (M.D, torch.nn.functional.pad(M.U, (0, w)),
            torch.nn.functional.pad(M.V, (0, 0, 0, w)))


def _blr_matmul_batched(A: BLRMatrix, B: BLRMatrix, C: BLRMatrix, eps):
    """Middle-index sweep: for each k, one batched Schur-style product per
    target class and operand classes accumulates all A_ik·B_kj
    contributions, then one batched recompression truncates the touched LR
    targets — the same step machinery as :func:`blr_lu`, replacing the
    reference's per-(i,j,k) recursion (add_hmatrix_hmatrix_product.hpp:24-312)."""
    nL, Rh = A.nL, C.R_half
    A_ops, B_ops = _widen_lr(A, Rh), _widen_lr(B, Rh)
    rows = []
    for k in range(nL):
        tgt = {g: {key: [] for key in ("ac", "a", "bc", "b", "t")} for g in ("sd", "sl")}
        touched = set()
        for i in range(nL):
            cik = A.cls[i, k]
            if cik == ZERO:
                continue
            ia = int(A.dense_slot[i, k] if cik == DENSE else A.lr_slot[i, k])
            for j in range(nL):
                ckj = B.cls[k, j]
                if ckj == ZERO:
                    continue
                jb = int(B.dense_slot[k, j] if ckj == DENSE else B.lr_slot[k, j])
                if C.cls[i, j] == DENSE:
                    g = tgt["sd"]
                    g["t"].append(int(C.dense_slot[i, j]))
                else:
                    g = tgt["sl"]
                    g["t"].append(int(C.lr_slot[i, j]))
                    touched.add(int(C.lr_slot[i, j]))
                g["ac"].append(cik)
                g["a"].append(ia)
                g["bc"].append(ckj)
                g["b"].append(jb)
        row = {**_flat_groups(tgt["sd"], "sd_"), **_flat_groups(tgt["sl"], "sl_")}
        if touched:
            row["rc"] = sorted(touched)
        rows.append(row)
    for tab in _pack(rows, C.device):
        _schur_dense(C.D, A_ops, B_ops, tab, "sd_", Rh, neg=False)
        _schur_lr(C.U, C.V, C.ranks, A_ops, A.ranks, B_ops, B.ranks, tab, "sl_", Rh, neg=False)
        if "rc" in tab:
            _recompress(C.U, C.V, C.ranks, tab["rc"], eps, Rh)
    return C


# ======================================================================
# factorization accuracy guard
# ======================================================================


def widen_blr(A: BLRMatrix, R_half: int) -> BLRMatrix:
    """Return a copy of (unfactorized) ``A`` with LR buffers widened to a
    larger ``R_half`` — the rank-cap escalation step.  Cell contents are
    unchanged (padding is zero)."""
    if A.factorized:
        raise ValueError("widen_blr applies to unfactorized matrices")
    R_half = int(-(-R_half // 8) * 8)
    if R_half <= A.R_half:
        return A
    w = 2 * R_half - A.U.shape[2]
    return replace(
        A,
        U=torch.nn.functional.pad(A.U, (0, w)),
        V=torch.nn.functional.pad(A.V, (0, 0, 0, w)),
        R_half=R_half,
        info=dict(A.info),
        cache={},
    )


def _factor_matvec(F: BLRMatrix, z):
    """Apply the FACTORIZATION as an operator: (L̂·Û) z for LU, (L·Lᴴ) z
    for Cholesky — used to sample the backward error ‖A − LU‖."""
    z, squeeze = _as_rhs(F, z)
    zc = _to_cells(F, z, torch.promote_types(F.dtype, z.dtype))  # [nL, b, k]
    diag = F.D[_index([int(F.dense_slot[i, i]) for i in range(F.nL)], F.device)].to(zc.dtype)

    if F.kind == "chol":
        Lw = torch.tril(diag)
        # w = Lᴴ z: each strict-lower cell L_ij contributes L_ijᴴ z_i to row j
        w = _cells_product(F, zc, _cells_tables(F, "L"), adjoint=True) + Lw.mH @ zc
        y = _cells_product(F, w, _cells_tables(F, "L")) + Lw @ w
    else:
        # w = Û z: strict upper cells + diag A_kk z, A_kk = P L U from its LU
        P, L, Ut = torch.lu_unpack(diag, F.piv)
        w = _cells_product(F, zc, _cells_tables(F, "U")) + P @ (L @ (Ut @ zc))
        # y = L̂ w (unit diag)
        y = _cells_product(F, w, _cells_tables(F, "L")) + w

    out = _from_cells(F, y)
    return out[:, 0] if squeeze else out


def blr_backward_error(A: BLRMatrix, F: BLRMatrix, n_probe: int = 4, seed: int = 0):
    """Stochastic backward-error estimate of a factorization:
    ‖(A − L·U) Z‖_F / ‖A Z‖_F over ``n_probe`` Gaussian probes from
    ``np.random.default_rng(seed)`` (the reference's probes, drawn the same
    way) — the accuracy guard the reference lacks (its H-LU is silently
    approximate too; factorization.hpp:19-79)."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((A.n, n_probe))
    if A.dtype.is_complex:
        z = z + 1j * rng.standard_normal((A.n, n_probe))
    z = torch.as_tensor(z, device=A.device).to(A.dtype)
    az = blr_matvec(A, z)
    fz = _factor_matvec(F, z)
    den = float(torch.linalg.norm(az))
    return float(torch.linalg.norm(az - fz)) / (den if den != 0 else 1.0)


# ======================================================================
# compressed-RHS triangular solve (H-H solve surface)
# ======================================================================


def blr_transpose(B: BLRMatrix, conj: bool = False) -> BLRMatrix:
    """op(B) as a new BLRMatrix (cells mirrored, factors swapped)."""
    D, U, V = B.D.mT, B.V.mT, B.U.mT
    if conj:
        D, U, V = D.conj().resolve_conj(), U.conj().resolve_conj(), V.conj().resolve_conj()
    return replace(
        B,
        cls=B.cls.T.copy(),
        dense_slot=B.dense_slot.T.copy(),
        lr_slot=B.lr_slot.T.copy(),
        D=D.contiguous(),
        U=U.contiguous(),
        V=V.contiguous(),
        info=dict(B.info),
        cache={},
    )


def blr_triangular_solve_matrix(F: BLRMatrix, B: BLRMatrix, which: str = "L",
                                side: str = "L", trans: str = "N",
                                epsilon: Optional[float] = None) -> BLRMatrix:
    """Solve ``op(T)·X = B`` (side 'L') or ``X·op(T) = B`` (side 'R') where
    ``B`` AND the result are compressed BLR matrices — the reference's H-H
    triangular solve (``triangular_hmatrix_hmatrix_solve.hpp:19-198``).

    One sweep per block-column of B (a dense [n, b] slab at a time); each
    result column is re-tiled and every cell compressed back by batched SVD
    at ``epsilon`` (dense when not advantageous)."""
    if side == "R":
        # X op(T) = B  <=>  op(T)ᵀ Xᵀ = Bᵀ
        if trans == "C":
            Xt = blr_triangular_solve_matrix(F, blr_transpose(B, conj=True), which, "L", "N",
                                             epsilon)
            return blr_transpose(Xt, conj=True)
        flipped = "T" if trans == "N" else "N"
        Xt = blr_triangular_solve_matrix(F, blr_transpose(B), which, "L", flipped, epsilon)
        return blr_transpose(Xt)

    if F.nL != B.nL or F.b != B.b or not np.array_equal(F.cell_off, B.cell_off):
        # factors cannot be re-tiled (their triangular structure is bound to
        # the factorization grid) — re-tile the RHS onto the factor grid
        from .conversion import retile_blr

        B = retile_blr(B, np.asarray(F.cell_off), np.asarray(F.cell_size), b=F.b)
    eps = B.epsilon if epsilon is None else epsilon
    nL, b, Rh = B.nL, B.b, B.R_half
    dtype = torch.promote_types(F.dtype, B.dtype)
    dev = B.device

    cls = np.zeros((nL, nL), np.int8)
    dense_slot = np.full((nL, nL), -1, np.int32)
    lr_slot = np.full((nL, nL), -1, np.int32)
    D_list, U_list, V_list, r_list = [], [], [], []
    zero = torch.zeros((b, b), dtype=B.dtype, device=dev)

    def cell(i, j):
        if B.cls[i, j] == DENSE:
            return B.D[int(B.dense_slot[i, j])]
        if B.cls[i, j] == LR:
            s = int(B.lr_slot[i, j])
            return B.U[s][:, :Rh] @ B.V[s][:Rh, :]
        return zero

    for j in range(nL):
        # materialize column j of B as a dense slab [n, b]
        colD = torch.stack([cell(i, j) for i in range(nL)])  # [nL, b, b]
        slab = _from_cells(B, colD.to(dtype))  # [n, b]
        xs = blr_triangular_solve(F, slab, which=which, side="L", trans=trans)
        xc = _to_cells(B, xs, dtype)  # [nL, b, b]
        # compress every cell of the column at once
        Uj, sj, Vj = torch.linalg.svd(xc, full_matrices=False)
        rj = svd_truncation_rank(sj, eps).cpu().numpy()
        for i in range(nL):
            r = int(rj[i])
            if r == 0:
                continue
            if r * 2 * b < b * b and r <= Rh:
                cls[i, j] = LR
                lr_slot[i, j] = len(U_list)
                Uc = torch.zeros((b, 2 * Rh), dtype=dtype, device=dev)
                Vc = torch.zeros((2 * Rh, b), dtype=dtype, device=dev)
                Uc[:, :r] = Uj[i][:, :r] * sj[i][:r][None, :].to(dtype)
                Vc[:r, :] = Vj[i][:r, :]
                U_list.append(Uc)
                V_list.append(Vc)
                r_list.append(r)
            else:
                cls[i, j] = DENSE
                dense_slot[i, j] = len(D_list)
                D_list.append(xc[i])

    D = torch.stack(D_list + [torch.zeros((b, b), dtype=dtype, device=dev)])
    U = torch.stack(U_list + [torch.zeros((b, 2 * Rh), dtype=dtype, device=dev)])
    V = torch.stack(V_list + [torch.zeros((2 * Rh, b), dtype=dtype, device=dev)])
    ranks = torch.as_tensor(np.array(r_list + [0], np.int32), device=dev)
    return BLRMatrix(
        n=B.n,
        cell_off=B.cell_off,
        cell_size=B.cell_size,
        b=b,
        cls=cls,
        dense_slot=dense_slot,
        lr_slot=lr_slot,
        D=D,
        U=U,
        V=V,
        ranks=ranks,
        R_half=Rh,
        epsilon=eps,
        permutation=B.permutation,
        info=dict(level=B.info.get("level"), n_cells=nL),
    )
