"""The port's nested (three-level) two-level BLR against the JAX package's,
in float64 and complex128: diagonal panels that are themselves
``TwoLevelBLR`` matrices (``build_blr2(diag_mode="nested")``).

The JAX package's nested build is not reliable under load (its
``tests/test_blr2.py:247`` oracle failed at rel 2.07e-5 on a second identical
build in a loaded process), so the factorization parity carries the
JAX-BUILT panels across with ``blr2_from_numpy`` and factorizes the same
matrix in both packages; the port's own nested build is held against the
JAX build and against the dense oracle.  Tolerances: 1e-10 between the
packages, and solves within 1e-6 of the exact solution (ε = 1e-9)."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import htool_tpu as hj
import htool_tpu_torch as ht
from htool_tpu.hmatrix import blr2 as jb2
from htool_tpu.testing import create_sphere
from htool_tpu.testing import kernels as kernels_jax
from htool_tpu_torch.convert import blr2_from_numpy, tree_from_numpy
from htool_tpu_torch.hmatrix import blr2 as tb2
from htool_tpu_torch.testing import kernels as kernels_torch
from torch_parity import blr2_to_numpy, tree_fields

PARITY = 1e-10
N = 900
KW = dict(epsilon=1e-9, coarse_size=512, diag_mode="nested", mid_size=128)


def rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


def _rhs(k, complex_, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, k))
    return x + 1j * rng.standard_normal((N, k)) if complex_ else x


def _op(A, trans):
    return {"N": A, "T": A.T, "C": A.conj().T}[trans]


def _points_tree():
    pts = create_sphere(N)
    tree_j = hj.ClusterTreeBuilder(max_leaf_size=40, backend="python").build(pts)
    return pts, tree_j, tree_from_numpy(tree_fields(tree_j))


@pytest.fixture(scope="module")
def nested():
    pts, tree_j, tree_t = _points_tree()
    gen_j = hj.KernelGenerator(kernels_jax.laplace_kernel_symmetric, pts, pts)
    gen_t = ht.KernelGenerator(kernels_torch.laplace_kernel_symmetric, pts, pts)
    A_j = jb2.build_blr2(gen_j, tree_j, **KW)
    # before A_j is factorized (the JAX factorization alters its panels)
    A_jt = blr2_from_numpy(blr2_to_numpy(A_j), device="cpu")
    ratio_j = A_j.compression_info()["compression_ratio"]
    Ad = np.asarray(gen_j.to_dense())
    return dict(A_j=A_j, A_jt=A_jt, ratio_j=ratio_j, A_t=tb2.build_blr2(gen_t, tree_t, **KW),
                F_j=jb2.blr2_lu(A_j), F_t=tb2.blr2_lu(A_jt), Ad=Ad,
                Ac=Ad[np.ix_(tree_j.permutation, tree_j.permutation)])


def test_nested_build_parity(nested):
    A_jt, A_t = nested["A_jt"], nested["A_t"]
    assert A_t.info["n_levels"] == 3 and A_t.info["nested_diag"]
    assert all(isinstance(p, tb2.TwoLevelBLR) and p.nC >= 2 for p in A_t.diag)
    assert (A_t.nC, A_t.P, A_t.R) == (A_jt.nC, A_jt.P, A_jt.R)
    for p_t, p_j in zip(A_t.diag, A_jt.diag):
        assert (p_t.nC, p_t.P, p_t.R) == (p_j.nC, p_j.P, p_j.R)
        np.testing.assert_array_equal(p_t.pRank.numpy(), p_j.pRank.numpy())
        np.testing.assert_array_equal(p_t.panel_off, p_j.panel_off)
    assert rel(A_t.to_dense(), A_jt.to_dense()) < PARITY
    assert rel(A_t.to_dense(user_numbering=True), nested["Ad"]) < 1e-6
    assert A_t.memory_bytes() == A_jt.memory_bytes()
    # the port sums exact stored counts; the JAX package rebuilds a nested
    # panel's count from its ratio, int(n² / ratio), so the two may differ
    # by a few entries
    ratio = A_t.compression_info()["compression_ratio"]
    assert ratio == pytest.approx(A_jt.compression_info()["compression_ratio"], rel=1e-12)
    assert ratio == pytest.approx(nested["ratio_j"], rel=1e-5)
    x = _rhs(3, False, 0)
    y = tb2.blr2_matvec(A_t, torch.as_tensor(x)).numpy()
    assert rel(y, nested["Ac"] @ x) < 1e-6


@pytest.mark.parametrize("trans", ["N", "T", "C"])
def test_nested_lu_parity(nested, trans):
    """The same JAX-built panels factorized in both packages."""
    F_j, F_t = nested["F_j"], nested["F_t"]
    assert F_t.info["n_rank_capped_pairs"] == F_j.info["n_rank_capped_pairs"]
    x = _rhs(2, False, 1)
    b = _op(nested["Ad"], trans) @ x
    s_j = np.asarray(jb2.blr2_solve(F_j, b, user_numbering=True, trans=trans))
    s_t = tb2.blr2_solve(F_t, torch.as_tensor(b), user_numbering=True, trans=trans).numpy()
    assert rel(s_t, s_j) < PARITY
    assert rel(s_t, x) < 1e-6
    for p_t, p_j in zip(F_t.diag, F_j.diag):
        np.testing.assert_array_equal(p_t.perms.numpy(), np.asarray(p_j.perms))
        assert rel(p_t.Dd.numpy(), np.asarray(p_j.Dd)) < PARITY


def test_jax_nested_factors_solved_by_port(nested):
    F = blr2_from_numpy(blr2_to_numpy(nested["F_j"]), device="cpu")
    x = _rhs(2, False, 2)
    for trans in ("N", "T"):
        b = _op(nested["Ad"], trans) @ x
        s = tb2.blr2_solve(F, torch.as_tensor(b), user_numbering=True, trans=trans).numpy()
        assert rel(s, x) < 1e-6, trans


@pytest.mark.parametrize("kind", ["lu", "chol"])
def test_port_nested_build_factorizes(nested, kind):
    """The port's own nested build, factorized, against the dense oracle."""
    F = (tb2.blr2_cholesky if kind == "chol" else tb2.blr2_lu)(nested["A_t"])
    assert F.info["backward_error_est"] < 1e-6
    x = _rhs(2, False, 3)
    for trans in ("N", "T"):
        b = _op(nested["Ad"], trans) @ x
        s = tb2.blr2_solve(F, torch.as_tensor(b), user_numbering=True, trans=trans).numpy()
        assert rel(s, x) < 1e-6, trans


@pytest.mark.parametrize("trans", ["N", "C"])
def test_port_nested_complex(trans):
    """Nested LU of the complex-symmetric kernel, with the conjugate-
    transpose reduction (tests/test_blr2.py:293), against the oracle."""
    pts, _, tree_t = _points_tree()
    gen_t = ht.KernelGenerator(kernels_torch.laplace_kernel_complex_symmetric, pts, pts)
    A = tb2.build_blr2(gen_t, tree_t, **KW)
    F = tb2.blr2_lu(A)
    assert F.info["backward_error_est"] < 1e-6
    Ad = gen_t.to_dense().numpy()
    x = _rhs(2, True, 4)
    b = _op(Ad, trans) @ x
    s = tb2.blr2_solve(F, torch.as_tensor(b), user_numbering=True, trans=trans).numpy()
    assert rel(s, x) < 1e-6
