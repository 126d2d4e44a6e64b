"""The control: the reference put in the program's place, computing in a
precision below the configuration's.

The configurations state float32 (complex64) with TF32 off, so the nearest
precision below is TF32: every product rounds its two operands to TF32's 10
mantissa bits and sums in float32, which is what a TF32 tensor-core product
does.  The rounding is done here explicitly, so the control means the same
on every device and for complex operands.  Its solve is plain restarted
GMRES without a preconditioner, to the configuration's tolerance; its
product is the kernel matrix of the points, evaluated in blocks of rows.
A sound comparison must call the ``tf32`` control's answers wrong.

Two more precisions ask what the comparison can see: ``tf32_offdiag`` and
``bf16_offdiag`` round every entry but the diagonal (and the entries of x
only where an off-diagonal entry multiplies them), as a program would that
keeps its near field exact and computes its far field low.
"""

from __future__ import annotations

import torch

from .dense import BLOCK_BYTES, entries


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 (or both parts of complex64) to the nearest TF32 value,
    ties to even."""
    if t.is_complex():
        return torch.complex(round_tf32(t.real.contiguous()), round_tf32(t.imag.contiguous()))
    # on the bits as int32: a finite float's bits plus 0x1000 never cross the
    # sign bit, and the low bits of a negative int32 are those of its pattern
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + (0xFFF + ((bits >> 13) & 1))) & -(1 << 13)
    return bits.view(torch.float32)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """Round float32 (or both parts of complex64) to the nearest bfloat16
    value, kept in float32."""
    if t.is_complex():
        return torch.complex(round_bf16(t.real.contiguous()), round_bf16(t.imag.contiguous()))
    return t.to(torch.float32).to(torch.bfloat16).to(torch.float32)


# precision: (rounding, the diagonal kept exact)
PRECISIONS = {"tf32": (round_tf32, False), "tf32_offdiag": (round_tf32, True),
              "bf16_offdiag": (round_bf16, True)}


class LowPrecisionDense:
    """Products and solves with the kernel matrix of ``points`` in a
    precision of ``PRECISIONS``."""

    def __init__(self, kernel, points: torch.Tensor, dtype: torch.dtype, precision: str):
        self.kernel = kernel
        self.points = points.to(torch.float32)
        self.dtype = dtype
        self.round, self.exact_diagonal = PRECISIONS[precision]
        self.products = 0

    def product(self, X: torch.Tensor) -> torch.Tensor:
        P = self.points
        n = P.shape[0]
        squeeze = X.ndim == 1
        X = (X[:, None] if squeeze else X).to(self.dtype)
        Xr = self.round(X)
        step = max(1, BLOCK_BYTES // (n * 3 * 4))
        out = []
        for i in range(0, n, step):
            rows = torch.arange(i, min(i + step, n), device=P.device)
            block = entries(self.kernel, P[rows], P).to(self.dtype)
            if self.exact_diagonal:
                diag = block[torch.arange(rows.numel(), device=P.device), rows]
                block[torch.arange(rows.numel(), device=P.device), rows] = 0
                out.append(self.round(block) @ Xr + diag[:, None] * X[rows])
            else:
                out.append(self.round(block) @ Xr)
        self.products += 1
        Y = torch.cat(out)
        return Y[:, 0] if squeeze else Y

    def solve(self, B: torch.Tensor, tol: float, maxiter: int, restart: int):
        """(X, converged)."""
        squeeze = B.ndim == 1
        X, converged = gmres(self.product, B[:, None] if squeeze else B, tol, maxiter, restart)
        return (X[:, 0] if squeeze else X), converged


class Problem:
    def __init__(self, points: torch.Tensor, dense: LowPrecisionDense):
        self.points = points
        self.dense = dense


class Control:
    """The control in the program's place, for ``harness.runner.run``: the
    same inputs, its own answers.  Its solve reports the products it made
    as its iterations."""

    # the restart of its GMRES where the configuration's solve states none
    RESTART = 50

    def __init__(self, cfg: dict, kernel, device: torch.device, precision: str = "tf32"):
        self.cfg = cfg
        self.kernel = kernel
        self.device = device
        self.dtype = getattr(torch, cfg["dtype"])
        self.precision = precision

    def build(self, points32, spans) -> Problem:
        pts = torch.as_tensor(points32, device=self.device)
        return Problem(pts, LowPrecisionDense(self.kernel, pts, self.dtype, self.precision))

    def solve(self, problem: Problem, B: torch.Tensor, spans):
        solve = self.cfg["solve"]
        before = problem.dense.products
        X, converged = problem.dense.solve(B, solve["tol"], solve["maxiter"],
                                           solve.get("restart", self.RESTART))
        return X, problem.dense.products - before, converged

    def product(self, problem: Problem, X: torch.Tensor) -> torch.Tensor:
        return problem.dense.product(X)


def gmres(apply, B: torch.Tensor, tol: float, maxiter: int, restart: int):
    """Restarted GMRES on each column of B (independent Krylov spaces,
    stepped together), no preconditioner, until every column's relative
    residual ‖b − A x‖/‖b‖ is at most ``tol``, ``maxiter`` iterations, or a
    restart that does not halve the largest residual (in a low precision
    the residual stalls above ``tol``).  (X, converged)."""
    n, k = B.shape
    small = torch.complex128 if B.dtype.is_complex else torch.float64
    X = torch.zeros_like(B)
    bnorm = torch.linalg.vector_norm(B, dim=0).to(torch.float64)
    it = 0
    worst = float("inf")
    while True:
        R = B - apply(X)
        beta = torch.linalg.vector_norm(R, dim=0)
        rel = float(torch.max(beta.to(torch.float64) / bnorm))
        if rel <= tol:
            return X, True
        if it >= maxiter or rel > 0.5 * worst:
            return X, False
        worst = rel
        V = [R / torch.where(beta == 0, 1.0, beta)[None, :]]
        Hm = torch.zeros((k, restart + 1, restart), dtype=small, device=B.device)
        y = None
        for j in range(min(restart, maxiter - it)):
            W = apply(V[j])
            it += 1
            for i in range(j + 1):
                h = torch.sum(V[i].conj() * W, dim=0)
                Hm[:, i, j] = h.to(small)
                W = W - h[None, :] * V[i]
            hn = torch.linalg.vector_norm(W, dim=0)
            Hm[:, j + 1, j] = hn.to(small)
            V.append(W / torch.where(hn == 0, 1.0, hn)[None, :])
            e = torch.zeros((k, j + 2, 1), dtype=small, device=B.device)
            e[:, 0, 0] = beta.to(small)
            Hj = Hm[:, : j + 2, : j + 1]
            y = torch.linalg.pinv(Hj) @ e
            res = torch.linalg.vector_norm((e - Hj @ y)[:, :, 0], dim=1).real
            if bool(torch.all(res <= tol * bnorm)):
                break
        Vs = torch.stack(V[: y.shape[1]])  # [j, n, k]
        X = X + torch.einsum("jnk,kj->nk", Vs, y[:, :, 0].to(B.dtype))
