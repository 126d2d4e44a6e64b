"""Mixed-operand products between dense matrices, low-rank pairs and
H-matrices.

Port of ``htool_tpu/hmatrix/lr_linalg.py`` (the reference's mixed linalg
headers ``hmatrix/linalg/add_matrix_hmatrix_product.hpp``,
``add_lrmat_hmatrix_product.hpp``, ``add_hmatrix_lrmat_product.hpp`` and
the LR algebra in ``hmatrix/lrmat/linalg/*``).

A low-rank operand is a plain ``LowRank(U, V)`` pair of tensors (the
single-block analog of the stacked ``LowRankBucket``).  Every product
reduces to matmuls on the factors, and H-matrix operands go through the
bucket products of :mod:`.linalg` (a left operand through the transpose
products, never by materializing the H-matrix), so on a GPU they run the
product kernels.  Truncated LR+LR addition concatenates the factors and
calls the batched QR+SVD recompression with batch size 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .compressors import batched_recompress, svd_truncation_rank
from .hmatrix import HMatrix
from .linalg import matmat

__all__ = [
    "LowRank",
    "lrmat_from_dense",
    "lrmat_vector_product",
    "lrmat_matrix_product",
    "matrix_lrmat_product",
    "lrmat_lrmat_product",
    "add_lrmat_lrmat",
    "matrix_hmatrix_product",
    "hmatrix_lrmat_product",
    "lrmat_hmatrix_product",
    "scale_lrmat",
]


class LowRank(NamedTuple):
    """A single low-rank block ``U @ V`` (``hmatrix/lrmat/lrmat.hpp:15-128``).

    U: [m, r], V: [r, n].
    """

    U: torch.Tensor
    V: torch.Tensor

    @property
    def shape(self):
        return (self.U.shape[0], self.V.shape[1])

    @property
    def rank(self):
        return self.U.shape[1]

    def to_dense(self):
        return self.U @ self.V

    def conj_transpose(self, op: str = "T"):
        """op(U·V) as a LowRank: 'T' -> (Vᵀ, Uᵀ), 'C' -> (Vᴴ, Uᴴ)."""
        if op == "T":
            return LowRank(self.V.T, self.U.T)
        if op == "C":
            return LowRank(self.V.conj().T, self.U.conj().T)
        raise ValueError(op)


def _op(A, op: str):
    if op == "N":
        return A
    if op == "T":
        return A.T
    if op == "C":
        return A.conj().T
    raise ValueError(op)


def lrmat_from_dense(A, epsilon: float) -> LowRank:
    """Truncated-SVD factorization of a dense block at the reference's
    trailing-energy rank rule (``SVD_truncation.hpp:14-55``)."""
    A = torch.as_tensor(A)
    Uf, s, Vh = torch.linalg.svd(A, full_matrices=False)
    k = max(int(svd_truncation_rank(s[None, :], epsilon)[0]), 1)
    return LowRank(Uf[:, :k] * s[:k][None, :].to(A.dtype), Vh[:k])


def lrmat_vector_product(lr: LowRank, x, op: str = "N"):
    """op(U·V) @ x (``add_lrmat_vector_product.hpp:28``)."""
    if op == "N":
        return lr.U @ (lr.V @ x)
    if op == "T":
        return lr.V.T @ (lr.U.T @ x)
    if op == "C":
        return lr.V.conj().T @ (lr.U.conj().T @ x)
    raise ValueError(op)


def lrmat_matrix_product(lr: LowRank, B, op: str = "N", opb: str = "N") -> LowRank:
    """op(lr) · opb(B) -> LowRank (``add_lrmat_matrix_product.hpp:111``)."""
    a = lr if op == "N" else lr.conj_transpose(op)
    return LowRank(a.U, a.V @ _op(torch.as_tensor(B), opb))


def matrix_lrmat_product(A, lr: LowRank, opa: str = "N", op: str = "N") -> LowRank:
    """opa(A) · op(lr) -> LowRank (``add_matrix_lrmat_product.hpp:115``)."""
    b = lr if op == "N" else lr.conj_transpose(op)
    return LowRank(_op(torch.as_tensor(A), opa) @ b.U, b.V)


def lrmat_lrmat_product(a: LowRank, b: LowRank, opa: str = "N", opb: str = "N") -> LowRank:
    """opa(a) · opb(b) -> LowRank of rank min(ra, rb)
    (``add_lrmat_lrmat_product.hpp:103``): the inner factor ``Va·Ub`` is
    absorbed into the side with larger rank."""
    a = a if opa == "N" else a.conj_transpose(opa)
    b = b if opb == "N" else b.conj_transpose(opb)
    mid = a.V @ b.U  # [ra, rb]
    if a.rank <= b.rank:
        return LowRank(a.U, mid @ b.V)
    return LowRank(a.U @ mid, b.V)


def add_lrmat_lrmat(a: LowRank, b: LowRank, epsilon: float) -> LowRank:
    """Truncated LR+LR addition (``add_lrmat_lrmat.hpp:14-108``): concatenate
    factors, QR+SVD recompress at epsilon (``SVD_recompression.hpp:18-181``)."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    U = torch.cat([a.U, b.U], dim=1)
    V = torch.cat([a.V, b.V], dim=0)
    U2, V2, new_rank = batched_recompress(
        U[None], V[None], torch.tensor([U.shape[1]], device=U.device), epsilon
    )
    k = max(int(new_rank[0]), 1)
    return LowRank(U2[0, :, :k], V2[0, :k, :])


def matrix_hmatrix_product(X, h: HMatrix, op: str = "N", oph: str = "N"):
    """op(X) · oph(H) dense result (``add_matrix_hmatrix_product.hpp``):
    computed through the H-matrix transpose products, ``(X·H) = (Hᵀ·Xᵀ)ᵀ``,
    so the H operand is never materialized."""
    Xo = _op(torch.as_tensor(X, device=h.device), op)
    # Xo @ oph(H) = ( oph(H)^T @ Xo^T )^T ; map oph -> the h-product mode
    # op2 with op2(H) = oph(H)^T: N->T, T->N, C->conj = conj(N of conj)
    if oph == "N":
        return matmat(h, Xo.T, op="T").T
    if oph == "T":
        return matmat(h, Xo.T, op="N").T
    if oph == "C":  # oph(H)^T = conj(H)
        return matmat(h, Xo.T.conj(), op="N").conj().T
    raise ValueError(oph)


def hmatrix_lrmat_product(h: HMatrix, lr: LowRank, oph: str = "N") -> LowRank:
    """oph(H) · lr -> LowRank (``add_hmatrix_lrmat_product.hpp``): only the
    thin U factor flows through the H product."""
    return LowRank(matmat(h, lr.U, op=oph), lr.V)


def lrmat_hmatrix_product(lr: LowRank, h: HMatrix, oph: str = "N") -> LowRank:
    """lr · oph(H) -> LowRank (``add_lrmat_hmatrix_product.hpp``)."""
    return LowRank(lr.U, matrix_hmatrix_product(lr.V, h, oph=oph))


def scale_lrmat(alpha, lr: LowRank) -> LowRank:
    """alpha · lr (``lrmat/linalg/scale.hpp``)."""
    return LowRank(alpha * lr.U, lr.V)
