"""The port's two-level BLR (``hmatrix/blr2.py``) against the JAX package's,
in float64 and complex128, with the dense and flat-BLR diagonal modes (the
nested mode is ``test_torch_blr2_nested.py``): the same points, cluster tree
(carried across) and generator through ``build_blr2``, ``blr2_lu`` /
``blr2_cholesky`` and ``blr2_solve`` under N, T and C in both packages.
Tolerances: builds, factors and solves agree to 1e-10 (relative) and stay
within ε of the dense oracle; the backward-error estimates agree.

In the flat-BLR diagonal mode the JAX package's factorization writes the
pending Schur updates into the INPUT matrix's diagonal panels, so its
``backward_error_est`` is taken against that altered matrix; the port
leaves its input as it was (``test_blr_mode_leaves_the_input_alone``)."""

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
KW = dict(epsilon=1e-9, coarse_size=256, block_size=64)


def rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


def _rhs(n, k, complex_, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, k))
    return x + 1j * rng.standard_normal((n, k)) if complex_ else x


def _case(kernel, n=N, **kw):
    pts = create_sphere(n)
    tree_j = hj.ClusterTreeBuilder(max_leaf_size=40, backend="python").build(pts)
    tree_t = tree_from_numpy(tree_fields(tree_j))
    gen_j = hj.KernelGenerator(getattr(kernels_jax, kernel), pts, pts)
    gen_t = ht.KernelGenerator(getattr(kernels_torch, kernel), pts, pts)
    Ad = np.asarray(gen_j.to_dense())
    Pm = tree_j.permutation
    A_j = jb2.build_blr2(gen_j, tree_j, **KW, **kw)
    x = _rhs(n, 3, "complex" in kernel, 0)
    # the JAX build as built: its flat-BLR factorization alters A_j's panels
    built_j = dict(dense=A_j.to_dense(), x=x, y=np.asarray(jb2.blr2_matvec(A_j, x)),
                   memory_bytes=A_j.memory_bytes(),
                   ratio=A_j.compression_info()["compression_ratio"])
    return dict(A_j=A_j, built_j=built_j, A_t=tb2.build_blr2(gen_t, tree_t, **KW, **kw),
                Ad=Ad, Ac=Ad[np.ix_(Pm, Pm)], tree_t=tree_t, gen_t=gen_t)


@pytest.fixture(scope="module")
def dense():
    c = _case("laplace_kernel_symmetric", diag_mode="dense")
    c["F_j"], c["F_t"] = jb2.blr2_lu(c["A_j"]), tb2.blr2_lu(c["A_t"])
    return c


@pytest.fixture(scope="module")
def cplx():
    c = _case("laplace_kernel_complex_symmetric", diag_mode="dense")
    c["F_j"] = jb2.blr2_lu(c["A_j"], error_estimate=False)
    c["F_t"] = tb2.blr2_lu(c["A_t"], error_estimate=False)
    return c


@pytest.fixture(scope="module")
def blr():
    c = _case("laplace_kernel_symmetric", diag_mode="blr")
    # the port factorizes the JAX-built panels, so the factors compare
    # directly; its own build is compared with the JAX one
    c["A_jt"] = blr2_from_numpy(blr2_to_numpy(c["A_j"]), device="cpu")
    c["F_t"] = tb2.blr2_lu(c["A_jt"])
    c["F_j"] = jb2.blr2_lu(c["A_j"])
    return c


def _op(A, trans):
    return {"N": A, "T": A.T, "C": A.conj().T}[trans]


@pytest.mark.parametrize("case", ["dense", "cplx", "blr"])
def test_build_blr2_parity(request, case):
    c = request.getfixturevalue(case)
    A_j, A_t = c["A_j"], c["A_t"]
    assert isinstance(A_t, tb2.TwoLevelBLR) and A_t.nC >= 2
    assert (A_t.nC, A_t.P, A_t.R, A_t.diag_mode) == (A_j.nC, A_j.P, A_j.R, A_j.diag_mode)
    np.testing.assert_array_equal(A_t.pRank.numpy(), np.asarray(A_j.pRank))
    assert {k: A_t.info[k] for k in ("n_panels", "panel_rank_cap", "n_aca_failed", "n_levels")} \
        == {k: A_j.info[k] for k in ("n_panels", "panel_rank_cap", "n_aca_failed", "n_levels")}
    built_j = c["built_j"]
    assert A_t.memory_bytes() == built_j["memory_bytes"]
    assert A_t.compression_info()["compression_ratio"] == pytest.approx(built_j["ratio"],
                                                                        rel=1e-12)
    assert rel(A_t.to_dense(), built_j["dense"]) < PARITY
    assert rel(A_t.to_dense(user_numbering=True), c["Ad"]) < 1e-6
    y_t = tb2.blr2_matvec(A_t, torch.as_tensor(built_j["x"])).numpy()
    assert rel(y_t, built_j["y"]) < PARITY
    assert rel(y_t, c["Ac"] @ built_j["x"]) < 1e-6


@pytest.mark.parametrize("case", ["dense", "blr"])
def test_blr2_lu_parity(request, case):
    c = request.getfixturevalue(case)
    F_j, F_t = c["F_j"], c["F_t"]
    assert F_t.factorized and F_t.kind == "lu"
    assert F_t.info["n_rank_capped_pairs"] == F_j.info["n_rank_capped_pairs"]
    # factors of a truncated pair are defined up to a basis: compare U·V
    assert rel(F_t.pU @ F_t.pV, np.asarray(F_j.pU) @ np.asarray(F_j.pV)) < PARITY
    np.testing.assert_array_equal(F_t.pRank.numpy(), np.asarray(F_j.pRank))
    if case == "dense":
        np.testing.assert_array_equal(F_t.perms.numpy(), np.asarray(F_j.perms))
        assert rel(F_t.Dd.numpy(), np.asarray(F_j.Dd)) < PARITY
        assert F_t.info["backward_error_est"] == pytest.approx(
            F_j.info["backward_error_est"], rel=1e-3, abs=1e-15)
    else:
        for p_t, p_j in zip(F_t.diag, F_j.diag):
            assert rel(p_t.to_dense(), p_j.to_dense()) < PARITY
    assert F_t.info["backward_error_est"] < 1e-6


@pytest.mark.parametrize("trans", ["N", "T", "C"])
@pytest.mark.parametrize("case", ["dense", "cplx", "blr"])
def test_blr2_solve_parity(request, case, trans):
    c = request.getfixturevalue(case)
    x = _rhs(N, 2, case == "cplx", 1)
    b = _op(c["Ad"], trans) @ x
    s_j = np.asarray(jb2.blr2_solve(c["F_j"], b, user_numbering=True, trans=trans))
    s_t = tb2.blr2_solve(c["F_t"], torch.as_tensor(b), user_numbering=True, trans=trans).numpy()
    assert rel(s_t, s_j) < PARITY
    assert rel(s_t, x) < 1e-6


@pytest.mark.parametrize("case", ["dense", "cplx"])
def test_jax_factors_solved_by_port(request, case):
    """A JAX-factorized two-level matrix carried across (its diagonal
    panels' row permutations as they are) and solved by the port."""
    c = request.getfixturevalue(case)
    F = blr2_from_numpy(blr2_to_numpy(c["F_j"]), device="cpu")
    x = _rhs(N, 2, case == "cplx", 2)
    for trans in ("N", "T"):
        b = _op(c["Ad"], trans) @ x
        s = tb2.blr2_solve(F, torch.as_tensor(b), user_numbering=True, trans=trans).numpy()
        assert rel(s, x) < 1e-6, trans


@pytest.mark.parametrize("case", ["dense", "blr"])
def test_blr2_cholesky(request, case):
    """Cholesky on the real symmetric kernel: against the JAX package in
    the dense mode, against the dense oracle in both; 'C' ≡ 'N' and 'T'
    solves the conjugate system."""
    c = request.getfixturevalue(case)
    F_t = tb2.blr2_cholesky(c["A_t"])
    assert F_t.kind == "chol" and F_t.info["backward_error_est"] < 1e-6
    if case == "dense":
        F_j = jb2.blr2_cholesky(c["A_j"])
        assert rel(F_t.Dd.numpy(), np.asarray(F_j.Dd)) < PARITY
        assert F_t.info["backward_error_est"] == pytest.approx(
            F_j.info["backward_error_est"], rel=1e-3, abs=1e-15)
    x = _rhs(N, 2, False, 3)
    for trans in ("N", "T", "C"):
        b = _op(c["Ad"], trans) @ x
        s = tb2.blr2_solve(F_t, torch.as_tensor(b), user_numbering=True, trans=trans).numpy()
        assert rel(s, x) < 1e-6, trans


def test_blr_mode_leaves_the_input_alone(blr):
    """The port's factorization does not touch its input, and its estimate
    is the one the probes give against the dense oracle with the JAX
    package's factors (whose own estimate reads its altered input)."""
    before = blr["A_jt"].to_dense()
    F = tb2.blr2_lu(blr["A_jt"], error_estimate=False)
    assert np.array_equal(blr["A_jt"].to_dense(), before)
    est_t = tb2.blr2_backward_error(blr["A_jt"], F, n_probe=2)
    z = np.random.default_rng(0).standard_normal((N, 2))
    x = np.asarray(jb2.blr2_solve(blr["F_j"], z))
    est = np.linalg.norm(blr["Ac"] @ x - z) / np.linalg.norm(z)
    assert est_t < 1e-12 and est < 1e-12
    assert est_t == pytest.approx(est, rel=0.5)


def test_blr2_guards(dense):
    tree_t, gen_t = dense["tree_t"], dense["gen_t"]
    with pytest.raises(ValueError):
        tb2.build_blr2(gen_t, tree_t, coarse_size=10 * N)  # single panel
    with pytest.raises(ValueError):
        tb2.blr2_lu(dense["F_t"])  # double factorization
    with pytest.raises(ValueError):
        tb2.blr2_solve(dense["A_t"], np.zeros(N))  # not factorized
    with pytest.raises(ValueError):
        tb2.blr2_solve(dense["F_t"], np.zeros(N), trans="X")
    with pytest.raises(ValueError):
        tb2.build_blr2(gen_t, tree_t, coarse_size=256, diag_mode="bogus")
