"""H-matrix products (matvec / multi-RHS matmat) and dense export.

Port of ``htool_tpu/hmatrix/linalg.py`` (the reference's leaf-loop
products, ``hmatrix/linalg/add_hmatrix_vector_product.hpp:17-206``): per
bucket term, the tiled Hopper kernel over a prepared plan
(:mod:`..ops.tiled_matvec`), or, without a plan, the unplanned Hopper
kernels (:mod:`..ops.bucket_matvec`), for real and complex operators alike
(the kernels take complex64 and complex128 as scalars of their own).
Padded rows/cols are exact zeros, so no masking is needed.
Symmetric/hermitian mirrored contributions
(``add_hmatrix_vector_product.hpp:56-104``) are separate bucket terms with
the transposed/conjugated operand.

All core routines work in **cluster numbering** on 2-D ``[n, nrhs]``
tensors; user-numbering wrappers apply the permutations as gathers
(``add_hmatrix_vector_product.hpp:172-206``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.bucket_matvec import dense_bucket_matvec, lr_bucket_matvec
from ..ops.cut import lr_split_wanted
from ..ops.tiled_matvec import build_tile_plan, build_tile_plan_lr_split, tiled_bucket_matvec
from .hmatrix import DenseBucket, HMatrix

__all__ = [
    "matvec",
    "matvec_user",
    "matmat",
    "matmat_user",
    "prepare_tiled_matvec",
    "to_dense",
    "copy_diagonal",
    "copy_diagonal_user",
]


def _pad_in_of(h: HMatrix) -> int:
    widths = [b.block_shape for b in h.dense_buckets] + [
        b.block_shape for b in h.lr_buckets
    ]
    return max(
        max([w[0] for w in widths], default=1),
        max([w[1] for w in widths], default=1),
    )


def prepare_tiled_matvec(h: HMatrix, tile_rows: Optional[int] = None,
                         lr_split: Optional[bool] = None) -> HMatrix:
    """Attach tiled-product plans (:mod:`..ops.tiled_matvec`) to every
    bucket of a GLOBAL H-matrix, real or complex, both output sides, in
    place.  Products then run the tiled Hopper kernels on every bucket term.
    A low-rank bucket gets a one-launch plan or a split two-stage plan
    (``build_tile_plan_lr_split``) by :func:`..ops.cut.lr_split_wanted` on its
    number of blocks, block shape, rank and scalar size; ``lr_split`` True or False forces one
    of them for every low-rank bucket.  Call once, after assembly."""
    if h.t_root_off != 0:
        raise ValueError("tiled plans require a global (non-restricted) H-matrix")
    pad_in = _pad_in_of(h)
    m, n = h.shape
    for bucket in h.dense_buckets + h.lr_buckets:
        build = build_tile_plan
        if not isinstance(bucket, DenseBucket):
            bm, bn = bucket.block_shape
            split = lr_split if lr_split is not None else lr_split_wanted(
                bucket.n_blocks, bm, bn, bucket.rank_padded, bucket.U.element_size())
            if split and bucket.rank_padded > 0:
                build = build_tile_plan_lr_split
        bucket.plan_t = build(bucket, "t", m + pad_in, tile_rows)
        bucket.plan_s = build(bucket, "s", n + pad_in, tile_rows)
    return h


def _bucket_terms(bucket, op: str, symmetry: str):
    """Return (in_side, out_side, mode, is_mirror) contribution terms for a
    bucket under product op in {'N','T','C'}.

    The stored block A sits at (t, s).  A symmetric matrix additionally has
    g(A) at (s, t) with g = transpose ('S') or conj-transpose ('H') for
    mirror buckets.  Sides are 't' or 's'.  For partition-restricted
    symmetric storage, mirror blocks live inside the diagonal partition
    block, so their 's'-side offsets are in ROW (local) space — the caller
    localizes the 's' side of mirror terms and the 't' side of stored terms.
    """
    terms = []
    if op == "N":
        terms.append(("s", "t", "N", False))
    elif op == "T":
        terms.append(("t", "s", "T", False))
    elif op == "C":
        terms.append(("t", "s", "C", False))
    else:
        raise ValueError(op)

    if bucket.mirror:
        if symmetry == "S":
            # g(A) = A^T at (s, t)
            mirror_modes = {"N": "T", "T": "N", "C": "conj"}
        elif symmetry == "H":
            # g(A) = A^H at (s, t)
            mirror_modes = {"N": "C", "T": "conj", "C": "N"}
        else:
            raise ValueError("mirror bucket in non-symmetric matrix")
        mode = mirror_modes[op]
        if op == "N":
            terms.append(("t", "s", mode, True))
        else:
            terms.append(("s", "t", mode, True))
    return terms


def _term_offsets(h: HMatrix, bucket, in_side: str, out_side: str, is_mirror: bool):
    """(in_off, out_off, in_root, out_root) of one bucket term: the bucket's
    offsets on each side, and the root offset to subtract from them.  The
    "row/local" side, localized by ``t_root_off``, is 't' for stored terms
    and 's' for mirror terms (see :func:`_bucket_terms`)."""
    local_side = "s" if is_mirror else "t"

    def side(s):
        return (bucket.t_off if s == "t" else bucket.s_off,
                h.t_root_off if s == local_side else 0)

    (in_off, in_root), (out_off, out_root) = side(in_side), side(out_side)
    return in_off, out_off, in_root, out_root


def matvec(h: HMatrix, x, op: str = "N"):
    """Product in cluster numbering: ``op(H) @ x``.

    ``x``: [N] or [N, k] (cluster numbering of the source tree for 'N',
    target for 'T'/'C').  For a partition-restricted block-row, 'N' returns
    the local rows; 'T'/'C' takes the local rows slice as input and returns a
    GLOBAL-size output (the caller reduces across partitions).

    A bucket term with a plan runs the tiled kernel
    (:func:`..ops.tiled_matvec.tiled_bucket_matvec`); a term without one
    runs the unplanned kernels (:func:`..ops.bucket_matvec.dense_bucket_matvec`,
    :func:`..ops.bucket_matvec.lr_bucket_matvec`).  Mode 'T' applies the
    stored blocks transposed, 'C' transposed and conjugated, 'conj'
    conjugated (the mirrored terms of hermitian storage).  When the
    product's dtype is wider than the H-matrix's (a float64 or complex128
    input against float32 or complex64 blocks), the kernels run on the
    blocks cast to the product's dtype.  A real H-matrix applied to a
    complex x runs the real kernels on x and y viewed as real ``[·, 2k]``
    tensors (``torch.view_as_real``, no copy): the blocks are real, so the
    real and imaginary parts are 2k independent columns.  Each call adds
    one to ``matvec.products``.
    """
    x = torch.as_tensor(x, device=h.device)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]

    m_loc, n_glob = h.shape
    out_len = m_loc if op == "N" else n_glob
    dtype = torch.promote_types(h.dtype, x.dtype)
    k = x.shape[1]

    # pad widths: max block extent so gathers/scatters stay in range
    pad_in = _pad_in_of(h)
    x_pad = torch.cat([x.to(dtype), torch.zeros((pad_in, k), dtype=dtype, device=x.device)])
    y_pad = torch.zeros((out_len + pad_in, k), dtype=dtype, device=x.device)
    # what the kernels see: the product's dtype, or its real parts as columns
    kdtype, x_k, y_k = dtype, x_pad, y_pad
    if dtype.is_complex and not h.dtype.is_complex:
        kdtype = x_pad.real.dtype
        x_k = torch.view_as_real(x_pad).view(x_pad.shape[0], 2 * k)
        y_k = torch.view_as_real(y_pad).view(y_pad.shape[0], 2 * k)

    for bucket in h.dense_buckets + h.lr_buckets:
        is_dense = isinstance(bucket, DenseBucket)
        for in_side, out_side, mode, is_mirror in _bucket_terms(bucket, op, h.symmetry):
            plan = bucket.plan_t if out_side == "t" else bucket.plan_s
            trans = mode in ("T", "C")  # a side-"s" plan is a transposed one
            conj = kdtype.is_complex and mode in ("C", "conj")
            if plan is not None:
                if plan.out_len != y_pad.shape[0]:
                    raise ValueError(
                        f"tiled plan writes {plan.out_len} rows, the product has "
                        f"{y_pad.shape[0]}: prepare_tiled_matvec again after "
                        "changing the H-matrix"
                    )
                if plan.dtype != kdtype:
                    plan = plan.astype(kdtype)
                tiled_bucket_matvec(plan, x_k, out=y_k, conj=conj)
                continue

            in_off, out_off, in_root, out_root = _term_offsets(h, bucket, in_side, out_side,
                                                               is_mirror)
            kw = dict(in_root=in_root, out_root=out_root, out=y_k, conj=conj)
            if is_dense:
                dense_bucket_matvec(bucket.data.to(kdtype), in_off, out_off, x_k, trans,
                                    y_k.shape[0], **kw)
            else:
                lr_bucket_matvec(bucket.U.to(kdtype), bucket.V.to(kdtype), in_off, out_off,
                                 x_k, trans, y_k.shape[0], **kw)

    matvec.products += 1
    y = y_pad[:out_len]
    return y[:, 0] if squeeze else y


matvec.products = 0


def matmat(h: HMatrix, X, op: str = "N"):
    """Multi-RHS product in cluster numbering (row-major multi-RHS analog,
    ``add_hmatrix_matrix_product_row_major.hpp``)."""
    return matvec(h, X, op=op)


def matvec_user(h: HMatrix, x, op: str = "N"):
    """Product in USER numbering (global): permute in, product, permute out
    (``add_hmatrix_vector_product.hpp:172-206``).  Only valid for global
    (non-partition-restricted) H-matrices."""
    x = torch.as_tensor(x, device=h.device)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    n_in = h.shape[1] if op == "N" else h.shape[0]
    if x.shape[0] != n_in:
        raise ValueError(
            f"input has {x.shape[0]} rows, operator expects {n_in} (op={op!r})"
        )
    in_perm = h.perm_s if op == "N" else h.perm_t
    out_perm = h.perm_t if op == "N" else h.perm_s
    yc = matvec(h, x[in_perm], op=op)
    y = torch.empty_like(yc)
    y[out_perm] = yc
    return y[:, 0] if squeeze else y


def matmat_user(h: HMatrix, X, op: str = "N"):
    return matvec_user(h, X, op=op)


def copy_diagonal(h: HMatrix):
    """Diagonal of a square H-matrix in CLUSTER numbering (``copy_diagonal``,
    hmatrix.hpp:401).  Diagonal entries live only in dense (inadmissible)
    blocks sitting on the diagonal, so this is a batched gather over the
    dense buckets."""
    m_loc, _ = h.shape
    out = torch.zeros((m_loc + 1,), dtype=h.dtype, device=h.device)  # last slot = trash
    for bucket in h.dense_buckets:
        bm, bn = bucket.block_shape
        t_loc = bucket.t_off - h.t_root_off
        # entry (t_off + i, s_off + i) is diagonal when global row == col
        ar = torch.arange(min(bm, bn), device=h.device)
        rows_g = bucket.t_off[:, None] + ar[None, :]
        cols_g = bucket.s_off[:, None] + ar[None, :]
        vals = bucket.data[:, ar, ar]  # [nb, k]
        # padded rows of the last diagonal block would index past the end
        # (JAX drops such updates; index_add_ raises), so they go to the trash
        rows_loc = t_loc[:, None] + ar[None, :]
        on_diag = (rows_g == cols_g) & (rows_loc < m_loc)
        idx = torch.where(on_diag, rows_loc, m_loc)
        out.index_add_(0, idx.reshape(-1), torch.where(on_diag, vals, 0).reshape(-1))
    return out[:-1]


def copy_diagonal_user(h: HMatrix):
    """Diagonal in USER numbering (``copy_diagonal_in_user_numbering``,
    hmatrix.hpp:434).  Global square H-matrices only."""
    if h.t_root_off != 0 or h.shape[0] != h.shape[1]:
        raise ValueError("user-numbering diagonal requires a global square H-matrix")
    d = copy_diagonal(h)
    out = torch.zeros_like(d)
    out[h.perm_t] = d
    return out


def to_dense(h: HMatrix, user_numbering: bool = True) -> np.ndarray:
    """Materialize the dense matrix (``copy_to_dense``, hmatrix.hpp:298 and
    ``copy_to_dense_in_user_numbering:333``).  Host-side; for tests/oracles."""
    m_loc, n_glob = h.shape
    A = np.zeros((m_loc, n_glob), torch.empty((), dtype=h.dtype).numpy().dtype)

    def blocks(bucket):
        t_off = bucket.t_off.cpu().numpy()
        s_off = bucket.s_off.cpu().numpy()
        t_sz = np.asarray(bucket.t_sizes)
        s_sz = np.asarray(bucket.s_sizes)
        if isinstance(bucket, DenseBucket):
            data = bucket.data.cpu().numpy()
            for i in range(t_off.shape[0]):
                yield t_off[i], s_off[i], data[i, : t_sz[i], : s_sz[i]]
        else:
            U = bucket.U.cpu().numpy()
            V = bucket.V.cpu().numpy()
            for i in range(t_off.shape[0]):
                yield t_off[i], s_off[i], U[i, : t_sz[i]] @ V[i, :, : s_sz[i]]

    r0 = h.t_root_off
    for bucket in h.dense_buckets + h.lr_buckets:
        for toff, soff, blk in blocks(bucket):
            A[toff - r0 : toff - r0 + blk.shape[0], soff : soff + blk.shape[1]] = blk
            if bucket.mirror:
                g = blk.T if h.symmetry == "S" else np.conj(blk.T)
                # mirrored block lives at (s, t) — only valid for global
                # square symmetric matrices
                A[soff - r0 : soff - r0 + blk.shape[1], toff : toff + blk.shape[0]] = g

    if user_numbering:
        perm_t = h.perm_t.cpu().numpy()
        perm_s = h.perm_s.cpu().numpy()
        if h.t_root_off != 0 or m_loc != perm_t.shape[0]:
            raise ValueError(
                "user-numbering dense export requires a global (non-partition-"
                "restricted) H-matrix; use user_numbering=False"
            )
        out = np.zeros_like(A)
        out[np.ix_(perm_t, perm_s)] = A
        return out
    return A
