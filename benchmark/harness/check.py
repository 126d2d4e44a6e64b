"""The comparison that decides ``correct``.

Three numbers, each against its limit from the configuration file:

- ``residual``: the largest ‖b − A x‖/‖b‖ over the sampled answers and
  their columns, A the kernel matrix of the points, applied by the plain
  reference in float64.  It judges assembly, Schwarz and Krylov together:
  an operator or a solve that is wrong leaves it large.
- ``product_err``: the largest ‖y − A[rows] x‖/‖A[rows] x‖ over columns,
  y the rows of the program's own ``H @ x`` on sampled answers.  It judges
  the assembled operator and the product kernels on their own.
- ``unconverged``: units of the window whose solve did not report
  convergence (limit 0).
"""

from __future__ import annotations

import math

from reference import dense

# a non-finite reading is reported as this, so that the result stays JSON
NON_FINITE = 1e300


def _finite(v: float) -> float:
    return v if math.isfinite(v) else NON_FINITE


def compare(check_in, kernel, limits: dict, units: list) -> dict:
    """``{name: {"value": v, "limit": l}}``, in the order above."""
    residual = 0.0 if check_in.groups else NON_FINITE
    for points, B, X in check_in.groups:
        r = dense.residuals(kernel, points, B, X)
        residual = max(residual, _finite(float(r.max())))
    points, rows, X, Y = check_in.product
    err = _finite(float(dense.relative_errors(kernel, points, rows, X, Y).max()))
    return {
        "residual": {"value": residual, "limit": float(limits["residual"])},
        "product_err": {"value": err, "limit": float(limits["product_err"])},
        "unconverged": {"value": sum(not u["converged"] for u in units), "limit": 0},
    }


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
