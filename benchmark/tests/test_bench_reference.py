"""The plain reference and the control against a dense matrix at small n."""

import math

import numpy as np
import pytest
import torch

from harness import inputs
from harness.spec import Spec
from reference import control, dense

from conftest import ROOT

N = 1200


def numpy_matrix(points: np.ndarray, complex_: bool) -> np.ndarray:
    """The kernel matrix written out entry by entry from its formula, float64."""
    p = points.astype(np.float64)
    r = np.sqrt(((p[:, None, :] - p[None, :, :]) ** 2).sum(-1))
    A = 1.0 / (1e-5 + 4.0 * math.pi * r)
    return (1.0 + 1.0j) * A if complex_ else A


def complex_kernel(x, y):
    """(1 + i) times the configuration's kernel: a complex kernel of the
    form the reference also serves."""
    return (1.0 + 1.0j) * Spec(ROOT).kernel("laplace_symmetric")(x, y)


@pytest.mark.parametrize("complex_", [False, True])
def test_reference_against_dense(complex_, monkeypatch):
    kernel = complex_kernel if complex_ else Spec(ROOT).kernel("laplace_symmetric")
    pts = inputs.sphere_points(N, 11, 0)
    A = numpy_matrix(pts, complex_)
    X = np.random.default_rng(0).standard_normal((N, 3))
    # small blocks, so that the blocked path is the one tested
    monkeypatch.setattr(dense, "BLOCK_BYTES", 100 * N * 3 * 8)
    P = torch.as_tensor(pts)
    Y = dense.apply(kernel, P, torch.as_tensor(X)).numpy()
    assert np.abs(Y - A @ X).max() <= 1e-12 * np.abs(A @ X).max()
    rows = np.array([5, 17, 1100])
    Yr = dense.apply(kernel, P, torch.as_tensor(X), rows=torch.as_tensor(rows)).numpy()
    assert np.abs(Yr - (A @ X)[rows]).max() <= 1e-12 * np.abs(A @ X).max()

    B = A @ X
    res = dense.residuals(kernel, P, torch.as_tensor(B), torch.as_tensor(X)).numpy()
    assert res.max() < 1e-13
    X2 = X.copy()
    X2[0, 1] *= 1.1
    res2 = dense.residuals(kernel, P, torch.as_tensor(B), torch.as_tensor(X2)).numpy()
    want = np.linalg.norm(A[:, 0] * X[0, 1] * 0.1) / np.linalg.norm(B[:, 1])
    assert res2[1] == pytest.approx(want, rel=1e-6) and res2[0] < 1e-13
    err = dense.relative_errors(kernel, P, torch.as_tensor(rows), torch.as_tensor(X),
                                torch.as_tensor(B[rows] * (1 + 1e-3))).numpy()
    assert err == pytest.approx(1e-3, rel=1e-9)


def test_rhs_is_the_potential_of_its_source():
    pts = inputs.sphere_points(50, 3, 1, 2)
    src, ph = inputs.sources(2, 2.0, 3, 1, 2)
    assert np.allclose(np.linalg.norm(src, axis=1), 2.0)
    b = inputs.rhs(torch.as_tensor(pts), src, ph, torch.complex128).numpy()
    r = np.linalg.norm(pts.astype(np.float64)[:, None, :] - src[None], axis=2)
    assert np.allclose(b, np.exp(1j * ph)[None] / (4 * math.pi * r), rtol=1e-12)
    # the same keys give the same inputs; another k, other ones
    assert np.array_equal(pts, inputs.sphere_points(50, 3, 1, 2))
    assert not np.array_equal(pts, inputs.sphere_points(50, 3, 1, 3))
    # any whole seed, wider than 32 bits or negative
    for seed in (2**31 + 5, 2**40 + 1, -7):
        assert inputs.sphere_points(4, seed, 0).shape == (4, 3)


def test_round_tf32():
    x = torch.tensor([1.0, 1e5, -3.3e-7, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 0.0])
    r = control.round_tf32(x)
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)  # 10 mantissa bits left
    assert torch.all((r - x).abs() <= 2**-11 * x.abs())
    assert r[3] == 1.0 and r[4] == 1.0 + 4 * 2**-11  # ties to even
    z = control.round_tf32(torch.tensor([1e5 + 1e5j], dtype=torch.complex64))
    assert z.real == z.imag == control.round_tf32(torch.tensor([1e5]))


def test_control_solves_to_tf32_accuracy_only():
    """The control's GMRES converges in exact arithmetic's place, and stalls
    at TF32's accuracy, far above the configurations' 1e-6."""
    kernel = Spec(ROOT).kernel("laplace_symmetric")
    pts = torch.as_tensor(inputs.sphere_points(800, 4, 0))
    B = inputs.rhs(pts, *inputs.sources(2, 2.0, 4, 1, 0), torch.float32)
    X, converged = control.LowPrecisionDense(kernel, pts, torch.float32, "tf32").solve(
        B, 1e-6, 200, 60)
    res = dense.residuals(kernel, pts, B, X)
    assert not converged and 1e-5 < float(res.max()) < 1e-2
    X64, converged64 = control.gmres(lambda V: dense.apply(kernel, pts, V),
                                     B.to(torch.float64), 1e-10, 200, 60)
    assert converged64 and float(dense.residuals(kernel, pts, B, X64).max()) < 1e-9


def test_round_bf16():
    x = torch.tensor([1.0, 1e5, -3.3e-7, 1.0 + 2**-9, 1.0 + 3 * 2**-9])
    r = control.round_bf16(x)
    assert torch.all((r.view(torch.int32) & 0xFFFF) == 0)  # 7 mantissa bits left
    assert torch.all((r - x).abs() <= 2**-9 * x.abs())
    assert r[3] == 1.0 and r[4] == 1.0 + 4 * 2**-9  # ties to even


@pytest.mark.parametrize("precision", sorted(control.PRECISIONS))
def test_control_precisions(precision):
    """Applied to a unit vector: every precision rounds the off-diagonal
    entries by at most its unit round-off; the off-diagonal precisions keep
    the diagonal entry exact, ``tf32`` rounds it too."""
    kernel = Spec(ROOT).kernel("laplace_symmetric")
    pts = torch.as_tensor(inputs.sphere_points(300, 6, 0))
    e0 = torch.zeros(300)
    e0[0] = 1.0
    y = control.LowPrecisionDense(kernel, pts, torch.float32, precision).product(e0)
    col = dense.entries(kernel, pts, pts[:1])[:, 0]  # float32, as the control evaluates it
    unit = 2**-11 if precision.startswith("tf32") else 2**-8
    rel = ((y - col).abs() / col.abs())[1:]
    assert float(rel.max()) <= unit and float(rel.max()) > 0
    if precision == "tf32":
        assert y[0] != col[0] and abs(float(y[0] / col[0]) - 1) <= unit
    else:
        assert y[0] == col[0]
