"""Krylov solvers — CG and restarted GMRES with preconditioning.

Port of ``htool_tpu/solvers/krylov.py`` (the role of HPDDM's Krylov loop,
``solvers/ddm.hpp:193``).  The ``lax.while_loop`` iterations become Python
loops over tensors that read their stopping tests on the host; the
arithmetic is the reference's: per-column step sizes over multiple
right-hand sides, left preconditioning, modified Gram-Schmidt, the same
Givens convention, the preconditioned stopping test and a true final
residual.  The ``axis_name`` hook (mesh collectives) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["cg", "gmres", "KrylovResult"]


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual: float  # final relative residual, max over RHS columns
    converged: bool


def _vdot_cols(a, b):
    """Per-column <a, b> with conjugation: [n, k] x [n, k] -> [k]."""
    return torch.sum(a.conj() * b, dim=0)


def _norm_cols(a):
    return torch.sqrt(_vdot_cols(a, a).abs().real)


def _identity(v):
    return v


def _rhs(b, x0):
    b = torch.as_tensor(b)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    n, k = b.shape
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0, device=b.device).reshape(n, k)
    return b, x, squeeze


def cg(
    A: Callable,
    b,
    M: Optional[Callable] = None,
    x0=None,
    tol: float = 1e-6,
    maxiter: int = 200,
) -> KrylovResult:
    """Preconditioned conjugate gradient for SPD/HPD operators.

    ``A`` and ``M`` map [n, k] -> [n, k].  Stops when every column satisfies
    ``||b - A x|| <= tol * ||b||``.
    """
    b, x, squeeze = _rhs(b, x0)
    M = M or _identity

    bnorm = _norm_cols(b)
    bnorm = torch.where(bnorm == 0, 1.0, bnorm)

    r = b - A(x)
    z = M(r)
    p = z
    rz = _vdot_cols(r, z)
    it = 0
    while it < maxiter and bool(torch.any(_norm_cols(r) > tol * bnorm)):
        Ap = A(p)
        pAp = _vdot_cols(p, Ap)
        alpha = rz / torch.where(pAp == 0, 1.0, pAp)
        # freeze converged columns
        active = _norm_cols(r) > tol * bnorm
        alpha = torch.where(active, alpha, 0.0)
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * Ap
        z = M(r)
        rz_new = _vdot_cols(r, z)
        beta = rz_new / torch.where(rz == 0, 1.0, rz)
        beta = torch.where(active, beta, 0.0)
        p = z + beta[None, :] * p
        rz = rz_new
        it += 1
    res = float(torch.max(_norm_cols(r) / bnorm))
    out = x[:, 0] if squeeze else x
    return KrylovResult(out, it, res, res <= tol)


def gmres(
    A: Callable,
    b,
    M: Optional[Callable] = None,
    x0=None,
    tol: float = 1e-6,
    maxiter: int = 200,
    restart: int = 40,
) -> KrylovResult:
    """Left-preconditioned restarted GMRES(m) with modified Gram-Schmidt and
    Givens rotations, vectorized over RHS columns.

    Iterates on the preconditioned system ``M A x = M b``; the convergence
    test uses the preconditioned residual (HPDDM's default), with the final
    reported residual recomputed unpreconditioned.
    """
    b, x, squeeze = _rhs(b, x0)
    n, k = b.shape
    M = M or _identity
    Ax = A(x)  # first residual; also fixes the working dtype
    dtype = torch.promote_types(b.dtype, Ax.dtype)
    b = b.to(dtype)
    x = x.to(dtype)
    m = int(min(restart, maxiter))
    dev = b.device

    bnorm = _norm_cols(M(b))
    bnorm = torch.where(bnorm == 0, 1.0, bnorm)

    it = 0
    res = float("inf")
    while it < maxiter and res > tol:
        r = M(b - (Ax if Ax is not None else A(x))).to(dtype)  # [n, k]
        Ax = None
        beta = _norm_cols(r)  # [k]
        # Krylov basis: V [m+1, n, k]
        V = torch.zeros((m + 1, n, k), dtype=dtype, device=dev)
        V[0] = r / torch.where(beta == 0, 1.0, beta)[None, :]
        # Hessenberg (after Givens): H [m+1, m, k]; Givens coeffs cs/sn [m, k]
        H = torch.zeros((m + 1, m, k), dtype=dtype, device=dev)
        cs = torch.zeros((m, k), dtype=dtype, device=dev)
        sn = torch.zeros((m, k), dtype=dtype, device=dev)
        g = torch.zeros((m + 1, k), dtype=dtype, device=dev)
        g[0] = beta.to(dtype)

        # after j steps the rotated residual of each column is |g[j]|
        j = 0
        while j < m and bool(torch.any(g[j].abs() / bnorm > tol)):
            w = M(A(V[j])).to(dtype)  # [n, k]

            # modified Gram-Schmidt against V[0..j]
            hcol = torch.zeros((m + 1, k), dtype=dtype, device=dev)
            for i in range(j + 1):
                hij = _vdot_cols(V[i], w)
                w = w - hij[None, :] * V[i]
                hcol[i] = hij
            hlast = _norm_cols(w).to(dtype)
            hcol[j + 1] = hlast
            V[j + 1] = w / torch.where(hlast.abs() == 0, 1.0, hlast)[None, :]

            # apply previous Givens rotations to the new column.
            # Convention: G = [[c, s], [-conj(s), c]] with c real >= 0.
            for i in range(j):
                t1 = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                t2 = -sn[i].conj() * hcol[i] + cs[i] * hcol[i + 1]
                hcol[i] = t1
                hcol[i + 1] = t2

            # new Givens zeroing hcol[j+1]:
            # c = |h1|/d, s = phase(h1) * conj(h2)/d  ->  G [h1; h2] = [phase*d; 0]
            h1, h2 = hcol[j].clone(), hcol[j + 1].clone()
            denom = torch.sqrt(h1.abs() ** 2 + h2.abs() ** 2)
            denom_s = torch.where(denom == 0, 1.0, denom)
            absh1 = h1.abs()
            phase = torch.where(
                absh1 == 0, torch.ones_like(h1),
                h1 / torch.where(absh1 == 0, 1.0, absh1).to(h1.dtype),
            )
            c_new = (absh1 / denom_s).to(dtype)
            s_new = (phase * h2.conj() / denom_s.to(h1.dtype)).to(dtype)
            cs[j] = c_new
            sn[j] = s_new
            hcol[j] = c_new * h1 + s_new * h2
            hcol[j + 1] = 0.0
            H[:, j, :] = hcol

            # update residual vector g
            g1, g2 = g[j].clone(), g[j + 1].clone()
            g[j] = c_new * g1 + s_new * g2
            g[j + 1] = -s_new.conj() * g1 + c_new * g2
            it += 1
            j += 1

        # back-substitute H y = g over the j leading columns
        y = torch.zeros((m, k), dtype=dtype, device=dev)
        for i in reversed(range(j)):
            num = g[i] - torch.sum(H[i] * y, dim=0)
            hii = H[i, i]
            y[i] = num / torch.where(hii.abs() == 0, 1.0, hii)
        x = x + torch.einsum("jnk,jk->nk", V[:m], y)
        res = float(torch.max(_norm_cols(M(b - A(x))) / bnorm))

    # report the TRUE (unpreconditioned) relative residual
    tnorm = _norm_cols(b)
    tnorm = torch.where(tnorm == 0, 1.0, tnorm)
    true_res = float(torch.max(_norm_cols(b - A(x)) / tnorm))
    out = x[:, 0] if squeeze else x
    return KrylovResult(out, it, true_res, res <= tol)
