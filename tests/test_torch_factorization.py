"""The port's user-facing factorization surface (``lu_factorization``,
``cholesky_factorization``, ``lu_solve``, ``cholesky_solve`` and ``to_blr2``
of ``hmatrix/conversion.py``) against the JAX package's, in float64 and
complex128: a JAX-assembled H-matrix and its cluster tree are carried
across and factorized with ``method="blr"`` and ``"blr2"`` in both packages
(tests/test_blr2.py:170-210).  Tolerances: solves agree to 1e-10 and stay
within 1e-6 of the exact solution (ε = 1e-9)."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import htool_tpu as hj
from htool_tpu.testing import create_sphere
from htool_tpu.testing import kernels as kernels_jax
from htool_tpu_torch.convert import hmatrix_from_numpy, tree_from_numpy
from htool_tpu_torch.hmatrix import conversion as tc
from torch_parity import hmatrix_to_numpy, tree_fields

PARITY = 1e-10


def rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


def _hcase(n=1200, eps=1e-9, symmetry="N", kernel="laplace_kernel_symmetric"):
    pts = create_sphere(n)
    tree_j = hj.ClusterTreeBuilder(max_leaf_size=40, backend="python").build(pts)
    gen_j = hj.KernelGenerator(getattr(kernels_jax, kernel), pts, pts)
    kw = dict(symmetry=symmetry, UPLO="L") if symmetry != "N" else {}
    H_j = hj.build_hmatrix(gen_j, tree_j, epsilon=eps, eta=10.0, **kw)
    return dict(H_j=H_j, H_t=hmatrix_from_numpy(hmatrix_to_numpy(H_j), device="cpu"),
                tree_j=tree_j, tree_t=tree_from_numpy(tree_fields(tree_j)),
                A=np.asarray(gen_j.to_dense()), n=n)


@pytest.fixture(scope="module")
def hN():
    return _hcase()


@pytest.mark.parametrize("method", ["blr", "blr2"])
def test_lu_factorization_surface(hN, method):
    """lu_factorization / lu_solve (tests/test_blr2.py:170) in both packages."""
    kw = dict(epsilon=1e-9, block_size=80, method=method, coarse_size=512)
    F_j = hj.lu_factorization(hN["H_j"], hN["tree_j"], **kw)
    F_t = tc.lu_factorization(hN["H_t"], hN["tree_t"], **kw)
    assert isinstance(F_t, tc.TwoLevelBLR) == (method == "blr2")
    x = np.random.RandomState(3).randn(hN["n"], 2)
    for trans in ("N", "T"):
        b = (hN["A"].T if trans == "T" else hN["A"]) @ x
        s_t = tc.lu_solve(F_t, torch.as_tensor(b), trans=trans).numpy()
        assert rel(s_t, np.asarray(hj.lu_solve(F_j, b, trans=trans))) < PARITY
        assert rel(s_t, x) < 1e-6
    with pytest.raises(ValueError):
        tc.cholesky_solve(F_t, b)


@pytest.mark.parametrize("method", ["blr", "blr2"])
def test_cholesky_factorization_surface(method):
    c = _hcase(symmetry="S")
    kw = dict(epsilon=1e-9, block_size=80, method=method, coarse_size=512)
    F_j = hj.cholesky_factorization(c["H_j"], c["tree_j"], **kw)
    F_t = tc.cholesky_factorization(c["H_t"], c["tree_t"], **kw)
    x = np.random.RandomState(4).randn(c["n"])
    b = c["A"] @ x
    s_t = tc.cholesky_solve(F_t, torch.as_tensor(b)).numpy()
    assert rel(s_t, np.asarray(hj.cholesky_solve(F_j, b))) < PARITY
    assert rel(s_t, x) < 1e-6
    with pytest.raises(ValueError):
        tc.lu_solve(F_t, b)


def test_to_blr2_hermitian_and_auto(hN):
    """to_blr2 of the hermitian kernel's assembled H-matrix (near blocks
    stayed dense, so the panels are exact) and 'auto' keeping the flat path
    at small n."""
    c = _hcase(kernel="laplace_kernel_hermitian")
    A2_j = hj.to_blr2(c["H_j"], c["tree_j"], coarse_size=256, epsilon=1e-9)
    A2_t = tc.to_blr2(c["H_t"], c["tree_t"], coarse_size=256, epsilon=1e-9)
    assert A2_t.R == A2_j.R
    np.testing.assert_array_equal(A2_t.pRank.numpy(), np.asarray(A2_j.pRank))
    assert rel(A2_t.to_dense(), A2_j.to_dense()) < PARITY
    assert rel(A2_t.to_dense(user_numbering=True), c["A"]) < 1e-6
    F = tc.lu_factorization(c["H_t"], c["tree_t"], epsilon=1e-9, method="blr2", coarse_size=256)
    x = np.random.RandomState(8).randn(c["n"], 2) * (1 + 1j)
    for trans in ("N", "C"):
        b = (c["A"].conj().T if trans == "C" else c["A"]) @ x
        assert rel(tc.lu_solve(F, torch.as_tensor(b), trans=trans).numpy(), x) < 1e-6
    assert not isinstance(tc.lu_factorization(hN["H_t"], hN["tree_t"], epsilon=1e-9),
                          tc.TwoLevelBLR)
    with pytest.raises(ValueError):
        tc.lu_factorization(hN["H_t"], hN["tree_t"], method="dense")
