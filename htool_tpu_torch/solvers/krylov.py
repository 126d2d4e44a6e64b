"""Krylov solvers — CG, restarted GMRES and block GMRES with preconditioning.

Port of ``htool_tpu/solvers/krylov.py`` (the role of HPDDM's Krylov loop,
``solvers/ddm.hpp:193``).  The ``lax.while_loop`` iterations become Python
loops over tensors that read their stopping tests on the host (``_read``:
each read is counted in ``syncs`` and spanned as ``htool.krylov.wait``;
each iteration is a ``htool.krylov.step`` span, which ends with the next
iteration's stopping test); the arithmetic is the reference's: per-column
step sizes over multiple right-hand sides, left preconditioning, modified
Gram-Schmidt, the same Givens convention, the preconditioned stopping test
and a true final residual; for block GMRES the blocked Gram-Schmidt, the
Gram-based QR
through a shifted Cholesky factor and the least-squares residual per step.
The reference's ``axis_name`` hook is ``mesh=``: under a
:class:`..parallel.collectives.Mesh` the vectors are the per-partition
slices ``[P_local·m, k]`` of the distributed solver, and every dot product
sums over each slice and then over the partitions through ``psum`` (the
MPI_Allreduce of HPDDM's Krylov loop).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils.profiling import count, span

__all__ = ["cg", "gmres", "block_gmres", "KrylovResult"]


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


def _dots(mesh):
    """(vdot, norm, gram) over columns: plain, or, with ``mesh``, over
    per-partition slices [P_local·m, ·] summed per slice and then over the
    partitions (``psum``).  ``gram(a, b)`` is aᴴ b."""
    if mesh is None:
        return _vdot_cols, _norm_cols, lambda a, b: a.mH @ b
    from ..parallel.collectives import psum

    def part(a):
        return a.reshape(mesh.n_local, -1, a.shape[-1])

    def vdot(a, b):
        return psum(torch.sum(part(a).conj() * part(b), dim=1), mesh)

    def gram(a, b):
        return psum(part(a).mH @ part(b), mesh)

    return vdot, lambda a: torch.sqrt(vdot(a, a).abs().real), gram


def _identity(v):
    return v


def _read(t):
    """``t.item()``: a host read of a device value, for which the host waits
    on the device.  Counted in the process counter ``syncs``, spanned as
    ``htool.krylov.wait``."""
    count("syncs")
    with span("htool.krylov.wait"):
        return t.item()


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
    mesh=None,
) -> KrylovResult:
    """Preconditioned conjugate gradient for SPD/HPD operators.

    ``A`` and ``M`` map [n, k] -> [n, k].  Stops when every column satisfies
    ``||b - A x|| <= tol * ||b||``.  With ``mesh``, runs on per-partition
    vector slices (dots psum over the partitions; padded slice rows must be
    zero).
    """
    _vdot_cols, _norm_cols, _ = _dots(mesh)
    b, x, squeeze = _rhs(b, x0)
    M = M or _identity

    bnorm = _norm_cols(b)
    bnorm = torch.where(bnorm == 0, 1.0, bnorm)

    r = b - A(x)
    z = M(r)
    p = z
    rz = _vdot_cols(r, z)
    it = 0
    go = it < maxiter and _read(torch.any(_norm_cols(r) > tol * bnorm))
    while go:
        with span("htool.krylov.step"):  # a step ends with the next one's stopping test
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
            go = it < maxiter and _read(torch.any(_norm_cols(r) > tol * bnorm))
    res = _read(torch.max(_norm_cols(r) / bnorm))
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
    mesh=None,
) -> KrylovResult:
    """Left-preconditioned restarted GMRES(m) with modified Gram-Schmidt and
    Givens rotations, vectorized over RHS columns.

    Iterates on the preconditioned system ``M A x = M b``; the convergence
    test uses the preconditioned residual (HPDDM's default), with the final
    reported residual recomputed unpreconditioned.  With ``mesh``, runs on
    per-partition vector slices.
    """
    _vdot_cols, _norm_cols, _ = _dots(mesh)
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
        go = j < m and _read(torch.any(g[j].abs() / bnorm > tol))
        while go:
            with span("htool.krylov.step"):
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
                go = j < m and _read(torch.any(g[j].abs() / bnorm > tol))

        # back-substitute H y = g over the j leading columns
        y = torch.zeros((m, k), dtype=dtype, device=dev)
        for i in reversed(range(j)):
            num = g[i] - torch.sum(H[i] * y, dim=0)
            hii = H[i, i]
            y[i] = num / torch.where(hii.abs() == 0, 1.0, hii)
        x = x + torch.einsum("jnk,jk->nk", V[:m], y)
        res = _read(torch.max(_norm_cols(M(b - A(x))) / bnorm))

    # report the TRUE (unpreconditioned) relative residual
    tnorm = _norm_cols(b)
    tnorm = torch.where(tnorm == 0, 1.0, tnorm)
    true_res = _read(torch.max(_norm_cols(b - A(x)) / tnorm))
    out = x[:, 0] if squeeze else x
    return KrylovResult(out, it, true_res, res <= tol)


def _wide(dtype: torch.dtype) -> torch.dtype:
    """float64 / complex128: the dtype of block GMRES's small problems."""
    return torch.complex128 if dtype.is_complex else torch.float64


def _block_qr(W, gram):
    """Gram-based QR of the tall block W [n, mu]: W = Q R with R the
    conjugate transpose of the Cholesky factor of Wᴴ W (``gram(W, W)``),
    shifted by 1e-30 so the factor stays invertible when columns have
    converged.  The Gram matrix is formed in W's dtype and factored in
    double precision; R comes back in double."""
    mu = W.shape[1]
    G = gram(W, W).to(_wide(W.dtype))
    L = torch.linalg.cholesky(G + 1e-30 * torch.eye(mu, dtype=G.dtype, device=G.device))
    R = L.mH
    Q = torch.linalg.solve_triangular(R.to(W.dtype), W, upper=True, left=False)  # W R⁻¹
    return Q, R


def _lstsq_residual(Hm, gm):
    """Minimum-norm solution of min ‖Hm Y − gm‖ through the SVD, with the
    reference's cut of singular values below eps · max(shape) · s_max, and
    the residual norm of each column."""
    U, s, Vh = torch.linalg.svd(Hm, full_matrices=False)
    keep = s >= torch.finfo(s.dtype).eps * max(Hm.shape) * s[0]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0).to(Hm.dtype)
    Y = Vh.mH @ (s_inv[:, None] * (U.mH @ gm))
    r = gm - Hm @ Y
    return Y, torch.sqrt(torch.sum(r.abs() ** 2, dim=0))


def block_gmres(
    A: Callable,
    b,
    M: Optional[Callable] = None,
    x0=None,
    tol: float = 1e-6,
    maxiter: int = 200,
    restart: int = 20,
    mesh=None,
) -> KrylovResult:
    """Block GMRES(m): all right-hand-side columns share ONE Krylov subspace
    (block Arnoldi with blocked modified Gram-Schmidt + QR), so one operator
    application on the [n, mu] block advances every column — HPDDM's block
    methods, against :func:`gmres`, which iterates the columns jointly but
    with independent subspaces.

    ``maxiter`` counts BLOCK iterations (operator applications on the
    block).  The small least-squares problem min‖H̄ Y − E₁S‖_F, at most
    (m+1)·mu × m·mu, is solved again at every step for the stopping test.

    One difference from the reference, which keeps everything in the working
    dtype: the small problems (the block Hessenberg matrix, the Cholesky
    factors, the least squares) are held in double precision whatever the
    vectors' dtype.  In float64 / complex128 that changes nothing.  In
    float32 / complex64 the single-precision least-squares residual cannot
    be resolved much below 1e-6 of ‖M b‖, so at ``tol = 1e-6`` the stopping
    test sat on rounding noise and the count of one solve changed from run
    to run on the GPU (its atomics reorder the sums); in double it does not.
    With ``mesh``, runs on per-partition vector slices (the Gram products
    psum over the partitions).
    """
    _vdot_cols, _norm_cols, gram = _dots(mesh)
    b = torch.as_tensor(b)
    if b.ndim == 1:
        raise ValueError("block_gmres needs a 2-D [n, mu] right-hand side")
    b, x, _ = _rhs(b, x0)
    n, mu = b.shape
    M = M or _identity
    Ax = A(x)  # first residual; also fixes the working dtype
    dtype = torch.promote_types(b.dtype, Ax.dtype)
    b = b.to(dtype)
    x = x.to(dtype)
    m = int(min(restart, maxiter))
    dev = b.device
    small = _wide(dtype)

    bnorm = _norm_cols(M(b))
    bnorm = torch.where(bnorm == 0, 1.0, bnorm)

    it = 0
    res_now = float("inf")
    while it < maxiter and res_now > tol:
        R0 = M(b - (Ax if Ax is not None else A(x))).to(dtype)
        Ax = None
        V0, S = _block_qr(R0, gram)
        V = torch.zeros((m + 1, n, mu), dtype=dtype, device=dev)
        V[0] = V0
        # block Hessenberg, flattened: block (i, j) at rows i·mu.., cols j·mu..
        H = torch.zeros(((m + 1) * mu, m * mu), dtype=small, device=dev)
        g = torch.zeros(((m + 1) * mu, mu), dtype=small, device=dev)
        g[:mu] = S

        j = 0
        res = torch.full((mu,), float("inf"), dtype=bnorm.dtype, device=dev)
        go = j < m and it < maxiter and _read(torch.any(res > tol))
        while go:
            with span("htool.krylov.step"):
                W = M(A(V[j])).to(dtype)
                for i in range(j + 1):  # blocked modified Gram-Schmidt
                    Hij = gram(V[i], W)
                    W = W - V[i] @ Hij
                    H[i * mu : (i + 1) * mu, j * mu : (j + 1) * mu] += Hij
                Q, Rj = _block_qr(W, gram)
                H[(j + 1) * mu : (j + 2) * mu, j * mu : (j + 1) * mu] = Rj
                V[j + 1] = Q
                it += 1
                j += 1
                _, r = _lstsq_residual(H[: (j + 1) * mu, : j * mu], g[: (j + 1) * mu])
                res = r.to(bnorm.dtype) / bnorm
                go = j < m and it < maxiter and _read(torch.any(res > tol))

        Y, _ = _lstsq_residual(H[: (j + 1) * mu, : j * mu], g[: (j + 1) * mu])
        x = x + torch.einsum("jnp,jpq->nq", V[:j], Y.view(j, mu, mu).to(dtype))
        res_now = _read(torch.max(_norm_cols(M(b - A(x))) / bnorm))

    tnorm = _norm_cols(b)
    tnorm = torch.where(tnorm == 0, 1.0, tnorm)
    true_res = _read(torch.max(_norm_cols(b - A(x)) / tnorm))
    return KrylovResult(x, it, true_res, res_now <= tol)
