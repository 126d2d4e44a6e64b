"""The port's flat BLR arithmetic (``hmatrix/blr.py``) against the JAX
package's, in float64 and complex128: the same points, the same cluster tree
(carried across with ``tree_from_numpy``) and the same generator through
``build_blr``, ``blr_lu``/``blr_cholesky``, ``blr_solve`` under N, T and C,
``blr_matmul`` and the accuracy guard, in both packages; a JAX-factorized
matrix carried across with ``blr_from_numpy`` is solved by the port (the
pivot conventions of the two packages differ).  Tolerances: builds, factors
and solves agree to 1e-10 (relative), and each stays within ε of the dense
oracle."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import htool_tpu as hj
import htool_tpu_torch as ht
from htool_tpu.hmatrix import blr as jb
from htool_tpu.testing import create_sphere, grid_laplacian
from htool_tpu.testing import kernels as kernels_jax
from htool_tpu_torch.convert import blr_from_numpy, tree_from_numpy
from htool_tpu_torch.hmatrix import blr as tb
from htool_tpu_torch.testing import kernels as kernels_torch
from torch_parity import blr_to_numpy, tree_fields

PARITY = 1e-10


def rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


def _trees(pts, leaf):
    tree_j = hj.ClusterTreeBuilder(max_leaf_size=leaf, backend="python").build(pts)
    return tree_j, tree_from_numpy(tree_fields(tree_j))


def _case(kernel, n=1000, leaf=32, block=64, eps=1e-8, **kw):
    """Both packages' BLR matrices of one kernel on the sphere, and the
    cluster-numbered dense oracle."""
    pts = create_sphere(n)
    tree_j, tree_t = _trees(pts, leaf)
    gen_j = hj.KernelGenerator(getattr(kernels_jax, kernel), pts, pts)
    gen_t = ht.KernelGenerator(getattr(kernels_torch, kernel), pts, pts)
    Pm = tree_j.permutation
    Ac = np.asarray(gen_j.to_dense())[np.ix_(Pm, Pm)]
    B_j = jb.build_blr(gen_j, tree_j, epsilon=eps, block_size=block, **kw)
    B_t = tb.build_blr(gen_t, tree_t, epsilon=eps, block_size=block, **kw)
    return dict(B_j=B_j, B_t=B_t, Ac=Ac, n=n)


def _matrix_case(A, pts, leaf, block, eps):
    """Both packages' BLR matrices of a stored matrix (MatrixGenerator)."""
    tree_j, tree_t = _trees(pts, leaf)
    Pm = tree_j.permutation
    B_j = jb.build_blr(hj.MatrixGenerator(A), tree_j, epsilon=eps, block_size=block)
    B_t = tb.build_blr(ht.MatrixGenerator(A, device="cpu"), tree_t, epsilon=eps, block_size=block)
    return dict(B_j=B_j, B_t=B_t, Ac=A[np.ix_(Pm, Pm)], n=A.shape[0])


@pytest.fixture(scope="module")
def real():
    c = _case("laplace_kernel_symmetric")
    c["F_j"], c["F_t"] = jb.blr_lu(c["B_j"]), tb.blr_lu(c["B_t"])
    return c


@pytest.fixture(scope="module")
def cplx():
    c = _case("laplace_kernel_complex_symmetric")
    c["F_j"], c["F_t"] = jb.blr_lu(c["B_j"]), tb.blr_lu(c["B_t"])
    return c


def _rhs(n, k, complex_, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, k)
    return x + 1j * rng.randn(n, k) if complex_ else x


def _op(Ac, trans):
    return {"N": Ac, "T": Ac.T, "C": Ac.conj().T}[trans]


def test_build_blr_parity(real):
    B_j, B_t, Ac = real["B_j"], real["B_t"], real["Ac"]
    for name in ("cls", "dense_slot", "lr_slot", "cell_off", "cell_size"):
        np.testing.assert_array_equal(getattr(B_t, name), getattr(B_j, name), name)
    assert (B_t.b, B_t.R_half, B_t.nL) == (B_j.b, B_j.R_half, B_j.nL)
    np.testing.assert_array_equal(B_t.ranks.numpy(), np.asarray(B_j.ranks))
    info_j, info_t = B_j.compression_info(), B_t.compression_info()
    assert info_t == info_j
    assert info_t["n_lr_cells"] > 0 and info_t["n_dense_cells"] > 0
    assert rel(B_t.to_dense(), B_j.to_dense()) < PARITY
    assert rel(B_t.to_dense(), Ac) < 1e-8
    x = _rhs(real["n"], 2, False, 0)
    assert rel(tb.blr_matvec(B_t, torch.as_tensor(x)), jb.blr_matvec(B_j, x)) < PARITY


def test_blr_lu_parity(real):
    F_j, F_t = real["F_j"], real["F_t"]
    assert F_t.factorized and F_t.kind == "lu"
    for name in ("cls", "dense_slot", "lr_slot"):
        np.testing.assert_array_equal(getattr(F_t, name), getattr(F_j, name), name)
    assert F_t.info["n_rank_capped_cells"] == F_j.info["n_rank_capped_cells"] == 0
    assert F_t.info["R_half"] == F_j.info["R_half"]
    # torch keeps LAPACK's 1-based row swaps, the JAX package 0-based ones
    np.testing.assert_array_equal(F_t.piv.numpy(), np.asarray(F_j.piv) + 1)
    assert rel(F_t.to_dense(), F_j.to_dense()) < PARITY
    assert F_t.info["backward_error_est"] < 1e-10 and F_j.info["backward_error_est"] < 1e-10


@pytest.mark.parametrize("trans", ["N", "T", "C"])
@pytest.mark.parametrize("case", ["real", "cplx"])
def test_blr_solve_parity(request, case, trans):
    """Complex LU solved under N, T and C: torch's ``lu_solve(adjoint=True)``
    is the conjugate transpose, so T needs the conj trick — only complex
    cases tell the two apart."""
    c = request.getfixturevalue(case)
    x = _rhs(c["n"], 3, case == "cplx", 1)
    b = _op(c["Ac"], trans) @ x
    s_j = np.asarray(jb.blr_solve(c["F_j"], b, trans=trans))
    s_t = tb.blr_solve(c["F_t"], torch.as_tensor(b), trans=trans).numpy()
    assert rel(s_t, s_j) < PARITY
    assert rel(s_t, x) < 1e-6


@pytest.mark.parametrize("trans", ["N", "T", "C"])
@pytest.mark.parametrize("case", ["real", "cplx"])
def test_jax_factors_solved_by_port(request, case, trans):
    """The pivot test: a JAX-factorized matrix carried across (0-based swaps
    turned 1-based) and solved by the port."""
    c = request.getfixturevalue(case)
    F = blr_from_numpy(blr_to_numpy(c["F_j"]), device="cpu")
    x = _rhs(c["n"], 2, case == "cplx", 2)
    b = _op(c["Ac"], trans) @ x
    s = tb.blr_solve(F, torch.as_tensor(b), trans=trans).numpy()
    assert rel(s, np.asarray(jb.blr_solve(c["F_j"], b, trans=trans))) < PARITY
    assert rel(s, x) < 1e-6


def test_backward_error_from_the_same_probes(cplx):
    """The port's estimate of the JAX factors equals the JAX package's own:
    both draw Z from ``np.random.default_rng(seed)``."""
    F = blr_from_numpy(blr_to_numpy(cplx["F_j"]), device="cpu")
    est_t = tb.blr_backward_error(cplx["B_t"], F, n_probe=3, seed=5)
    est_j = jb.blr_backward_error(cplx["B_j"], cplx["F_j"], n_probe=3, seed=5)
    assert est_t == pytest.approx(est_j, rel=1e-3, abs=1e-15)


def test_accuracy_guard_parity():
    """Rank-cap detection, auto-escalation and the backward-error estimate
    (tests/test_blr.py:205) at R_half = 8: the capped count and the estimate
    of the capped factorization agree with the JAX package's; escalation
    widens the buffers until no cell is capped."""
    c = _case("laplace_kernel_symmetric", n=800, leaf=25, block=50, eps=1e-4, R_half=8)
    F0_j = jb.blr_lu(c["B_j"], epsilon=1e-12, auto_escalate=0)
    F0_t = tb.blr_lu(c["B_t"], epsilon=1e-12, auto_escalate=0)
    F1_t = tb.blr_lu(c["B_t"], epsilon=1e-12, auto_escalate=3)
    assert F0_t.info["n_rank_capped_cells"] == F0_j.info["n_rank_capped_cells"] > 0
    assert F0_t.info["R_half"] == F0_j.info["R_half"]
    assert F0_t.info["backward_error_est"] == pytest.approx(F0_j.info["backward_error_est"],
                                                           rel=1e-6)
    assert F1_t.info["n_rank_capped_cells"] == 0 and F1_t.info["R_half"] > F0_t.info["R_half"]
    assert F1_t.info["backward_error_est"] < 10 * 1e-4


@pytest.mark.parametrize("nrhs", [1, 3])
def test_blr_cholesky_grid_laplacian(nrhs):
    """SPD with fill-in (tests/test_blr.py:82): Cholesky in both packages."""
    pts, A = grid_laplacian((8, 8, 6))
    c = _matrix_case(A, pts, leaf=32, block=64, eps=1e-8)
    F_j, F_t = jb.blr_cholesky(c["B_j"]), tb.blr_cholesky(c["B_t"])
    assert F_t.kind == "chol" and F_t.piv is None
    np.testing.assert_array_equal(F_t.cls, F_j.cls)
    assert rel(F_t.to_dense(), F_j.to_dense()) < PARITY
    x = _rhs(c["n"], nrhs, False, 4)[:, 0] if nrhs == 1 else _rhs(c["n"], nrhs, False, 4)
    b = c["Ac"] @ x
    s_t = tb.blr_solve(F_t, torch.as_tensor(b)).numpy()
    assert s_t.shape == x.shape
    assert rel(s_t, np.asarray(jb.blr_solve(F_j, b))) < PARITY
    assert rel(s_t, x) < 1e-6
    # the grid LU (tests/test_blr.py:68) too
    L_t = tb.blr_lu(c["B_t"])
    assert rel(tb.blr_solve(L_t, torch.as_tensor(b)).numpy(), x) < 1e-6


@pytest.fixture(scope="module")
def hpd():
    """Complex HPD: the hermitian kernel made exactly hermitian, plus a shift."""
    n = 600
    pts = create_sphere(n)
    K = np.asarray(hj.KernelGenerator(kernels_jax.laplace_kernel_hermitian, pts, pts).to_dense())
    K = 0.5 * (K + K.conj().T)
    A = K + (max(0.0, -np.linalg.eigvalsh(K).min()) + 0.1) * np.eye(n)
    c = _matrix_case(A, pts, leaf=40, block=80, eps=1e-8)
    c["F_j"], c["F_t"] = jb.blr_cholesky(c["B_j"]), tb.blr_cholesky(c["B_t"])
    return c


@pytest.mark.parametrize("trans", ["N", "T", "C"])
def test_blr_cholesky_complex_hermitian(hpd, trans):
    """Complex HPD (tests/test_blr.py:119): the potrf 'H' path; T is the
    conjugate system."""
    F_j, F_t = hpd["F_j"], hpd["F_t"]
    assert rel(F_t.to_dense(), F_j.to_dense()) < PARITY
    x = _rhs(hpd["n"], 2, True, 6)
    b = _op(hpd["Ac"], trans) @ x
    s_t = tb.blr_solve(F_t, torch.as_tensor(b), trans=trans).numpy()
    assert rel(s_t, np.asarray(jb.blr_solve(F_j, b, trans=trans))) < PARITY
    assert rel(s_t, x) < 1e-6


def test_blr_solve_user_numbering(real):
    B_t, F_t = real["B_t"], real["F_t"]
    A_user = B_t.to_dense(user_numbering=True)
    x = _rhs(real["n"], 1, False, 3)[:, 0]
    s = tb.blr_solve(F_t, torch.as_tensor(A_user @ x), user_numbering=True).numpy()
    assert rel(s, x) < 1e-6


def test_blr_matmul_parity(real):
    C_j = jb.blr_matmul(real["B_j"], real["B_j"], epsilon=1e-8)
    C_t = tb.blr_matmul(real["B_t"], real["B_t"], epsilon=1e-8)
    np.testing.assert_array_equal(C_t.cls, C_j.cls)
    np.testing.assert_array_equal(C_t.ranks.numpy(), np.asarray(C_j.ranks))
    ref = real["Ac"] @ real["Ac"]
    assert rel(C_t.to_dense(), C_j.to_dense()) < PARITY
    assert rel(C_t.to_dense(), ref) < 1e-6


@pytest.mark.parametrize("which,trans", [("L", "N"), ("U", "N"), ("U", "T"), ("L", "C")])
def test_triangular_solve_parity(cplx, which, trans):
    """One factor at a time, left and right side, against the JAX package."""
    b = _rhs(cplx["n"], 2, True, 7)
    for side, rhs in (("L", b), ("R", b.T.copy())):
        s_j = np.asarray(jb.blr_triangular_solve(cplx["F_j"], rhs, which, side, trans))
        s_t = tb.blr_triangular_solve(cplx["F_t"], torch.as_tensor(rhs), which, side,
                                      trans).numpy()
        assert rel(s_t, s_j) < PARITY, side


def test_transpose_and_widen(real):
    B_t = real["B_t"]
    T_t = tb.blr_transpose(B_t, conj=True)
    assert rel(T_t.to_dense(), B_t.to_dense().conj().T) < 1e-14
    W_t = tb.widen_blr(B_t, 2 * B_t.R_half)
    assert W_t.R_half == 2 * B_t.R_half and W_t.R_buf == 4 * B_t.R_half
    assert rel(W_t.to_dense(), B_t.to_dense()) < 1e-14
    with pytest.raises(ValueError):
        tb.widen_blr(real["F_t"], 64)
    with pytest.raises(ValueError):
        tb.blr_solve(B_t, np.zeros(real["n"]))
