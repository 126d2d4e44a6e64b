"""Additional low-rank compressors: full-pivot ACA, truncated SVD, and
batched SVD recompression.

Port of ``htool_tpu/hmatrix/compressors.py``:

- fullACA (``hmatrix/lrmat/fullACA.hpp:16-89``): assemble the block, then
  full-pivot ACA with the exact Frobenius residual as stopping rule.
- SVD compressor (``hmatrix/lrmat/SVD.hpp:15-93``): truncated SVD with the
  trailing-energy criterion of ``SVD_truncation``
  (``matrix/utils/SVD_truncation.hpp:14-55``): smallest k with
  ‖σ_{k+1:}‖/‖σ‖ < ε.
- SVD recompression (``hmatrix/lrmat/utils/SVD_recompression.hpp:18-181``):
  QR(U)·LQ(V) -> small SVD of R·Lᵀ -> re-expand, batched over the blocks.

All routines are batched over a leading block axis and masked for padding,
like :mod:`.aca`.  The ``lax.while_loop`` of full ACA becomes a Python loop
that reads ``any(active)`` on the host each step, and the residual is
updated in place (one batched rank-1 update per step instead of a new
residual array).
"""

from __future__ import annotations

import torch

__all__ = [
    "batched_full_aca",
    "batched_svd_compress",
    "batched_recompress",
    "svd_truncation_rank",
]


def _assembled_blocks(gen, rows, cols, t_sizes, s_sizes):
    """The blocks [nb, m, n] with padded rows/cols zeroed, and the sizes as
    long tensors on the generator's device."""
    device = gen.device
    rows = torch.as_tensor(rows, device=device).long()
    cols = torch.as_tensor(cols, device=device).long()
    t_sizes = torch.as_tensor(t_sizes, device=device).long()
    s_sizes = torch.as_tensor(s_sizes, device=device).long()
    m, n = rows.shape[1], cols.shape[1]
    row_mask = torch.arange(m, device=device)[None, :] < t_sizes[:, None]
    col_mask = torch.arange(n, device=device)[None, :] < s_sizes[:, None]
    A = gen.block(rows, cols).masked_fill_(~(row_mask[:, :, None] & col_mask[:, None, :]), 0)
    return A, t_sizes, s_sizes


def batched_full_aca(gen, rows, cols, t_sizes, s_sizes, epsilon, rmax, reqrank=-1):
    """Full-pivot ACA on assembled blocks (fullACA.hpp:16-89).

    Returns (U [nb,m,rmax], V [nb,rmax,n], rank, failed).  The residual is
    tracked exactly: R_{k+1} = R_k − u vᵀ, pivot = global argmax |R|."""
    R, t_sizes, s_sizes = _assembled_blocks(gen, rows, cols, t_sizes, s_sizes)
    nb, m, n = R.shape
    device, dtype = R.device, R.dtype
    norm0 = torch.linalg.vector_norm(R, dim=(1, 2))

    U = torch.zeros((nb, m, rmax), dtype=dtype, device=device)
    V = torch.zeros((nb, rmax, n), dtype=dtype, device=device)
    barange = torch.arange(nb, device=device)
    q = torch.zeros((nb,), dtype=torch.long, device=device)
    active = torch.ones((nb,), dtype=torch.bool, device=device)
    failed = torch.zeros((nb,), dtype=torch.bool, device=device)
    if reqrank >= 0:
        limit = torch.minimum(torch.minimum(t_sizes, s_sizes),
                              torch.full_like(t_sizes, reqrank))

    k = 0
    while k < rmax and bool(active.any()):
        # advantage bound, as in partial ACA (partialACA.hpp:84)
        if reqrank < 0:
            not_adv = (k + 1) * (t_sizes + s_sizes) > t_sizes * s_sizes
        else:
            not_adv = torch.zeros_like(active)
        failed_now = active & not_adv
        active2 = active & ~not_adv

        flat = torch.argmax(R.abs().reshape(nb, -1), dim=1)
        I, J = flat // n, flat % n
        pivot = R[barange, I, J]
        zero = pivot.abs() <= 1e-15
        upd = active2 & ~zero

        u = R[barange, :, J]  # [nb, m]
        v = R[barange, I, :] / torch.where(zero, torch.ones_like(pivot), pivot)[:, None]
        u = torch.where(upd[:, None], u, 0)
        R.baddbmm_(u[:, :, None], v[:, None, :], alpha=-1)
        U[:, :, k] = u
        V[:, k, :] = torch.where(upd[:, None], v, 0)
        q = torch.where(upd, k + 1, q)

        if reqrank < 0:
            resnorm = torch.linalg.vector_norm(R, dim=(1, 2))
            converged = upd & (resnorm <= epsilon * torch.clamp(norm0, min=1e-300))
        else:
            converged = upd & (q >= limit)
        failed = failed | failed_now | (active2 & zero & (q == 0))
        active = upd & ~converged
        k += 1

    if reqrank < 0:
        failed = failed | active
    rank = torch.where(failed, 0, q)
    return U, V, rank, failed


def svd_truncation_rank(s, epsilon):
    """Rank by trailing-energy criterion (SVD_truncation.hpp:14-55):
    smallest k with ‖σ_{k+1:}‖ ≤ ε·‖σ‖.  s: [nb, p] descending."""
    tail = torch.sqrt(torch.flip(torch.cumsum(torch.flip(s, (1,)) ** 2, dim=1), (1,)))
    total = tail[:, :1]
    keep = tail > epsilon * torch.clamp(total, min=1e-300)
    # rank = number of leading singular values NOT coverable by the tail bound
    return keep.sum(dim=1).to(torch.int32)


def batched_svd_compress(gen, rows, cols, t_sizes, s_sizes, epsilon, rmax, reqrank=-1):
    """Truncated-SVD compressor (SVD.hpp:15-93): assemble, SVD, keep the
    epsilon-rank (or reqrank).  Returns (U, V, rank, failed)."""
    A, t_sizes, s_sizes = _assembled_blocks(gen, rows, cols, t_sizes, s_sizes)
    nb = A.shape[0]
    Uf, s, Vh = torch.linalg.svd(A, full_matrices=False)  # [nb,m,p],[nb,p],[nb,p,n]
    del A
    if reqrank < 0:
        rank = svd_truncation_rank(s, epsilon).long()
        # not advantageous -> dense (SVD.hpp:40)
        failed = rank * (t_sizes + s_sizes) > t_sizes * s_sizes
    else:
        rank = torch.clamp(torch.minimum(t_sizes, s_sizes), max=reqrank)
        failed = torch.zeros((nb,), dtype=torch.bool, device=s.device)
    rank = torch.where(failed, 0, rank)

    p = s.shape[1]
    w = min(p, rmax)
    keep = torch.arange(w, device=s.device)[None, :] < rank[:, None]
    U = Uf[:, :, :w] * torch.where(keep, s[:, :w], 0)[:, None, :].to(Uf.dtype)
    V = Vh[:, :w, :] * keep[:, :, None].to(Vh.dtype)
    if rmax > p:
        U = torch.nn.functional.pad(U, (0, rmax - p))
        V = torch.nn.functional.pad(V, (0, 0, 0, rmax - p))
    return U, V, rank, failed


def batched_recompress(U, V, ranks, epsilon):
    """SVD recompression of stacked LR factors
    (SVD_recompression.hpp:18-181): QR(U), LQ(V), SVD of R_U·R_Vᴴ, truncate
    at epsilon, re-expand.  ``ranks`` masks the valid columns of each block.

    Returns (U2, V2, new_ranks) with the same padded rank width."""
    nb, m, r = U.shape
    ranks = torch.as_tensor(ranks, device=U.device)
    keep = torch.arange(r, device=U.device)[None, :] < ranks[:, None]
    U = U * keep[:, None, :].to(U.dtype)
    V = V * keep[:, :, None].to(V.dtype)

    Qu, Ru = torch.linalg.qr(U)  # [nb,m,k1], [nb,k1,r], k1 = min(m,r)
    Qv, Rv = torch.linalg.qr(V.conj().transpose(1, 2))  # [nb,n,k2], [nb,k2,r]
    M = Ru @ Rv.conj().transpose(1, 2)  # [nb,k1,k2]
    Um, s, Vh = torch.linalg.svd(M, full_matrices=False)  # q = min(k1,k2)
    q = s.shape[1]
    new_rank = torch.minimum(svd_truncation_rank(s, epsilon), ranks.to(torch.int32))
    keep2 = torch.arange(q, device=U.device)[None, :] < new_rank[:, None]
    sv = torch.where(keep2, s, 0)
    U2 = Qu @ (Um * sv[:, None, :].to(U.dtype))  # [nb,m,q]
    V2 = Vh @ Qv.conj().transpose(1, 2)  # [nb,q,n]
    U2 = U2 * keep2[:, None, :].to(U.dtype)
    V2 = V2 * keep2[:, :, None].to(V.dtype)
    if q < r:
        U2 = torch.nn.functional.pad(U2, (0, r - q))
        V2 = torch.nn.functional.pad(V2, (0, 0, 0, r - q))
    return U2, V2, new_rank
