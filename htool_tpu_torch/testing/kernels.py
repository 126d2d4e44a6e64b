"""Analytic BEM-like test kernels in torch, matching
``htool_tpu/testing/kernels.py`` (the reference's fixture formulas,
``include/htool/testing/generator_test.hpp:155-205``).

All kernels broadcast over leading dimensions: ``k(x, y)`` with
``x, y : [..., d]`` -> ``[...]``.  Complex kernels return complex64 for
float32 points and complex128 for float64 points.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "laplace_kernel",
    "laplace_kernel_complex",
    "laplace_kernel_symmetric",
    "laplace_kernel_complex_symmetric",
    "laplace_kernel_hermitian",
    "helmholtz_kernel",
]

_FOUR_PI = 4.0 * math.pi


def _dist(x, y):
    return torch.sqrt(torch.sum((x - y) ** 2, dim=-1))


def laplace_kernel(x, y):
    """1/(4π‖x−y‖) — GeneratorTestDouble (generator_test.hpp:155-161)."""
    return 1.0 / (_FOUR_PI * _dist(x, y))


def laplace_kernel_complex(x, y):
    """(1+i)/(4π‖x−y‖) — GeneratorTestComplex (generator_test.hpp:163-170)."""
    return (1.0 + 1.0j) / (_FOUR_PI * _dist(x, y))


def laplace_kernel_symmetric(x, y):
    """1/(1e-5 + 4π‖x−y‖) — GeneratorTestDoubleSymmetric
    (generator_test.hpp:180-187); regularized so the diagonal is finite."""
    return 1.0 / (1e-5 + _FOUR_PI * _dist(x, y))


def laplace_kernel_complex_symmetric(x, y):
    """(1+i)/(1e-5 + 4π‖x−y‖) — GeneratorTestComplexSymmetric
    (generator_test.hpp:189-196)."""
    return (1.0 + 1.0j) / (1e-5 + _FOUR_PI * _dist(x, y))


def laplace_kernel_hermitian(x, y):
    """(1 + sign(x₀−y₀)·i)/(1e-5 + 4π‖x−y‖) — GeneratorTestComplexHermitian
    (generator_test.hpp:198-205); the imaginary part is antisymmetric, so
    the matrix is hermitian on a shared point set."""
    s = torch.sign(x[..., 0] - y[..., 0])
    return (1.0 + 1.0j * s) / (1e-5 + _FOUR_PI * _dist(x, y))


def helmholtz_kernel(wavenumber: float):
    """exp(ik‖x−y‖)/(4π‖x−y‖), regularized at 0 — oscillatory kernel for
    compression stress tests."""

    def k(x, y):
        r = _dist(x, y)
        return torch.exp(1.0j * wavenumber * r) / (1e-5 + _FOUR_PI * r)

    return k
