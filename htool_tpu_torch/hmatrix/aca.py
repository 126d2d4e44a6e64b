"""Batched partial ACA.

Port of ``htool_tpu/hmatrix/aca.py`` (the reference's sequential
partial-pivot ACA, ``hmatrix/lrmat/partialACA.hpp:42-184``, run as masked
pivoting steps for a whole bucket of admissible blocks at once).  The
``lax.while_loop`` becomes a Python loop that reads ``any(active)`` on the
host each step; the per-block state is the same:

- first pivot row is row 0 of the block (partialACA.hpp:51)
- pivot = argmax |residual| over unvisited cols/rows (partialACA.hpp:99-133)
- stopping estimator: incremental Frobenius norm of the accumulated low-rank
  matrix; stop when sqrt(aux/frob) <= epsilon (partialACA.hpp:78,136-150)
- advantage bound: abort to dense when rank·(M+N) > M·N (partialACA.hpp:84)
- zero pivot (<=1e-15): stop; dense fallback if it was the first cross
  (partialACA.hpp:115,158-165)
- crosses are committed in place into the U/V buffers, masked to the
  blocks still active (``aca.py:134-145``).
"""

from __future__ import annotations

import torch

__all__ = ["batched_partial_aca"]


def batched_partial_aca(
    gen,
    rows,  # [nb, m] int — user-numbering row indices (padded entries clamped)
    cols,  # [nb, n] int
    t_sizes,  # [nb] int — true (unpadded) block row counts
    s_sizes,  # [nb] int
    epsilon: float,
    rmax: int,
    reqrank: int = -1,
):
    """Returns (U [nb, m, rmax], V [nb, rmax, n], rank [nb], failed [nb]).

    ``failed`` marks blocks that must fall back to dense storage (the
    reference's "false positives", tree_builder.hpp:572-577).
    """
    device = gen.device
    rows = torch.as_tensor(rows, device=device).long()
    cols = torch.as_tensor(cols, device=device).long()
    t_sizes = torch.as_tensor(t_sizes, device=device).long()
    s_sizes = torch.as_tensor(s_sizes, device=device).long()
    nb, m = rows.shape
    n = cols.shape[1]
    dtype = gen.dtype

    ar_m = torch.arange(m, device=device)
    ar_n = torch.arange(n, device=device)
    row_mask = ar_m[None, :] < t_sizes[:, None]  # [nb, m]
    col_mask = ar_n[None, :] < s_sizes[:, None]  # [nb, n]

    U = torch.zeros((nb, m, rmax), dtype=dtype, device=device)
    V = torch.zeros((nb, rmax, n), dtype=dtype, device=device)
    visited_row = torch.zeros((nb, m), dtype=torch.bool, device=device)
    visited_col = torch.zeros((nb, n), dtype=torch.bool, device=device)
    I = torch.zeros((nb,), dtype=torch.long, device=device)
    frob = torch.zeros((nb,), dtype=U.real.dtype, device=device)
    q = torch.zeros((nb,), dtype=torch.long, device=device)
    active = torch.ones((nb,), dtype=torch.bool, device=device)
    failed = torch.zeros((nb,), dtype=torch.bool, device=device)
    eps2 = float(epsilon) ** 2
    barange = torch.arange(nb, device=device)
    neg_inf = torch.tensor(-torch.inf, dtype=frob.dtype, device=device)
    if reqrank >= 0:
        limit = torch.minimum(torch.minimum(t_sizes, s_sizes),
                              torch.full_like(t_sizes, reqrank))

    k = 0
    while k < rmax and bool(active.any()):
        # advantage bound (partialACA.hpp:84)
        if reqrank < 0:
            not_adv = (k + 1) * (t_sizes + s_sizes) > t_sizes * s_sizes
            failed = failed | (active & not_adv)
            active = active & ~not_adv

        # ---- row cross: residual of row I ----
        rows_I = rows[barange, I]  # [nb]
        r = gen.block(rows_I[:, None], cols)[:, 0, :]  # [nb, n]
        u_I = U[barange, I, :]  # [nb, rmax]
        r = r - torch.einsum("br,brn->bn", u_I, V)
        r = torch.where(col_mask, r, 0)

        pivot_score = torch.where(visited_col | ~col_mask, neg_inf, r.abs())
        J = torch.argmax(pivot_score, dim=1)  # [nb]
        rJ = r[barange, J]

        visited_row = visited_row | ((ar_m[None, :] == I[:, None]) & active[:, None])

        # zero pivot (partialACA.hpp:115,158-165)
        zero_pivot = rJ.abs() <= 1e-15
        failed = failed | (active & zero_pivot & (q == 0))
        active = active & ~zero_pivot

        # ---- column cross ----
        cols_J = cols[barange, J]  # [nb]
        c = gen.block(rows, cols_J[:, None])[:, :, 0]  # [nb, m]
        v_J = V[barange, :, J]  # [nb, rmax]
        c = c - torch.einsum("bmr,br->bm", U, v_J)
        gamma = torch.where(zero_pivot, torch.ones_like(rJ),
                            1.0 / torch.where(zero_pivot, torch.ones_like(rJ), rJ))
        c = c * gamma[:, None]
        c = torch.where(row_mask, c, 0)

        next_score = torch.where(visited_row | ~row_mask, neg_inf, c.abs())
        I_next = torch.argmax(next_score, dim=1)

        visited_col = visited_col | ((ar_n[None, :] == J[:, None]) & active[:, None])

        # ---- Frobenius estimator (partialACA.hpp:136-150) ----
        aux = torch.sum(c * c, dim=1).abs() * torch.sum(r * r, dim=1).abs()
        Vr = torch.einsum("brn,bn->br", V, r)  # [nb, rmax]
        Uc = torch.einsum("bmr,bm->br", U, c)  # [nb, rmax]
        frob_cross = torch.sum(Vr * Uc, dim=1)
        frob = torch.where(active, frob + aux + 2.0 * frob_cross.real, frob)

        # ---- commit cross k for still-active blocks, in place ----
        upd = active
        U[:, :, k] = torch.where(upd[:, None], c, U[:, :, k])
        V[:, k, :] = torch.where(upd[:, None], r, V[:, k, :])
        q = torch.where(upd, k + 1, q)
        I = torch.where(upd, I_next, I)

        # ---- stopping test ----
        if reqrank < 0:
            converged = upd & (aux <= eps2 * frob)
        else:
            converged = upd & (q >= limit)
        active = active & ~converged
        k += 1

    # blocks that never converged within rmax steps fall back to dense
    if reqrank < 0:
        failed = failed | active
    rank = torch.where(failed, 0, q)
    return U, V, rank, failed
