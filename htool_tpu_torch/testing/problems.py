"""Self-contained PDE-like test problems for the solver stack.

The reference's solver tests use golden data from a discretized PDE
(``tests/functional_tests/solvers/`` FetchContent dataset); the in-repo
analog is a finite-difference Laplacian on a 3-D grid — SPD with condition
O(h⁻²), the canonical target for Schwarz/GenEO preconditioners.

A copy of ``htool_tpu/testing/problems.py`` (NumPy only).
"""

from __future__ import annotations

import numpy as np

__all__ = ["grid_laplacian"]


def grid_laplacian(shape=(8, 8, 8), spacing: float = 1.0):
    """7-point-stencil Laplacian with Dirichlet boundary on an
    ``nx × ny × nz`` grid.

    Returns ``(points [n,3], A [n,n])`` with ``n = nx·ny·nz``; ``points``
    are the grid coordinates (so geometric clustering/partitioning aligns
    with the matrix graph).
    """
    nx, ny, nz = shape
    n = nx * ny * nz
    idx = np.arange(n).reshape(nx, ny, nz)
    A = np.zeros((n, n))
    A[np.arange(n), np.arange(n)] = 6.0
    for axis, dim in enumerate(shape):
        for shift in (1, -1):
            src = [slice(None)] * 3
            dst = [slice(None)] * 3
            if shift == 1:
                src[axis] = slice(0, dim - 1)
                dst[axis] = slice(1, dim)
            else:
                src[axis] = slice(1, dim)
                dst[axis] = slice(0, dim - 1)
            i = idx[tuple(src)].ravel()
            j = idx[tuple(dst)].ravel()
            A[i, j] = -1.0
    xs, ys, zs = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    points = spacing * np.stack(
        [xs.ravel(), ys.ravel(), zs.ravel()], axis=1
    ).astype(np.float64)
    return points, A
