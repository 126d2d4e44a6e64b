"""The plain reference: the kernel matrix of the benchmark's points, applied
in blocks of rows and never stored, in float64 (complex128 for a complex
kernel).

It takes the points and right-hand sides that the benchmark made, and the
solutions and products that the program returned, and nothing else of the
program: no operator, no tree, no preconditioner.  It imports plain PyTorch
only.
"""

from __future__ import annotations

import torch

# bytes of the [rows, n, 3] coordinate differences that one block of rows
# may take; the other temporaries of a block are a third of that each
BLOCK_BYTES = 1 << 30


def wide_dtype(kernel) -> torch.dtype:
    """The dtype of ``kernel`` on float64 points: float64 or complex128."""
    p = torch.zeros((1, 3), dtype=torch.float64)
    return kernel(p, p + 1.0).dtype


def entries(kernel, P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """``kernel(P_i, Q_j)`` for every pair, ``[len(P), len(Q)]``."""
    return kernel(P[:, None, :], Q[None, :, :])


def apply(kernel, points: torch.Tensor, X: torch.Tensor, rows=None) -> torch.Tensor:
    """``A[rows] @ X`` in the wide dtype, A the kernel matrix of ``points``
    ([n, 3], any float dtype, upcast to float64).  ``rows`` defaults to all."""
    P = points.to(torch.float64)
    n = P.shape[0]
    wide = wide_dtype(kernel)
    X = X.to(device=P.device, dtype=wide)
    if X.ndim == 1:
        X = X[:, None]
    rows = torch.arange(n, device=P.device) if rows is None else torch.as_tensor(rows, device=P.device)
    step = max(1, BLOCK_BYTES // (n * 3 * 8))
    out = []
    for i in range(0, rows.numel(), step):
        block = entries(kernel, P[rows[i : i + step]], P).to(wide)
        out.append(block @ X)
    return torch.cat(out)


def column_norms(Y: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(Y, dim=0)


def residuals(kernel, points, B, X) -> torch.Tensor:
    """‖b − A x‖ / ‖b‖ for each column (float64)."""
    wide = wide_dtype(kernel)
    B = B.to(device=points.device, dtype=wide)
    if B.ndim == 1:
        B = B[:, None]
    return column_norms(B - apply(kernel, points, X)) / column_norms(B)


def relative_errors(kernel, points, rows, X, Y_rows) -> torch.Tensor:
    """‖y − A[rows] x‖ / ‖A[rows] x‖ for each column, y a product's rows."""
    ref = apply(kernel, points, X, rows)
    Y = Y_rows.to(device=ref.device, dtype=ref.dtype)
    if Y.ndim == 1:
        Y = Y[:, None]
    return column_norms(Y - ref) / column_norms(ref)
