"""The port's main path end to end against the JAX package: sphere → cluster
tree (carried across) → H-matrix → one-level RAS → GMRES / CG, in f64."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import htool_tpu as hj
import htool_tpu_torch as ht
from htool_tpu.solvers import DDMSolver as JaxDDMSolver
from htool_tpu.testing import create_sphere
from htool_tpu.testing import laplace_kernel_symmetric as kernel_jax
from htool_tpu_torch.convert import tree_from_numpy
from htool_tpu_torch.hmatrix.linalg import prepare_tiled_matvec
from htool_tpu_torch.solvers import DDMSolver, build_geometric_overlap, cg, gmres
from htool_tpu_torch.testing import laplace_kernel_symmetric as kernel_torch
from torch_parity import tree_fields

N, P, TOL = 1500, 4, 1e-6


@pytest.fixture(scope="module")
def problem():
    pts = create_sphere(N)
    tree_j = hj.ClusterTreeBuilder(max_leaf_size=64, backend="python").build(pts, n_partitions=P)
    tree_t = tree_from_numpy(tree_fields(tree_j))
    gen_j = hj.KernelGenerator(kernel_jax, pts, pts)
    gen_t = ht.KernelGenerator(kernel_torch, pts, pts)
    H_j = hj.build_hmatrix(gen_j, tree_j, epsilon=1e-4, eta=10.0)
    H_t = ht.build_hmatrix(gen_t, tree_t, epsilon=1e-4, eta=10.0)
    prepare_tiled_matvec(H_t)
    A = gen_t.to_dense().numpy()
    b = np.random.RandomState(0).randn(N)
    return dict(tree_j=tree_j, tree_t=tree_t, gen_j=gen_j, gen_t=gen_t, H_j=H_j, H_t=H_t,
                A=A, b=b)


def test_overlap_parity(problem):
    from htool_tpu.solvers import build_geometric_overlap as jax_overlap

    oj = jax_overlap(problem["tree_j"], 0.15)
    ot = build_geometric_overlap(problem["tree_t"], 0.15)
    assert len(oj) == len(ot) == P
    for a, b in zip(oj, ot):
        np.testing.assert_array_equal(a, b)
    assert sum(o.size for o in ot) > 0


@pytest.mark.parametrize("krylov", ["gmres", "cg"])
def test_ras_solve_parity(problem, krylov):
    p = problem
    sj = JaxDDMSolver(p["H_j"], p["gen_j"], p["tree_j"], schwarz="ras", overlap_radius=0.15)
    st = DDMSolver(p["H_t"], p["gen_t"], p["tree_t"], schwarz="ras", overlap_radius=0.15)
    assert st.infos["Local_size_max"] == sj.infos["Local_size_max"]
    xj, ij = sj.solve(p["b"], tol=TOL, krylov=krylov, restart=40)
    xt, it = st.solve(p["b"], tol=TOL, krylov=krylov, restart=40)
    xj, xt = np.asarray(xj), xt.numpy()
    assert it["Nb_it"] == ij["Nb_it"] > 0
    A, b = p["A"], p["b"]
    for x in (xj, xt):
        assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < TOL
    assert np.linalg.norm(xt - xj) / np.linalg.norm(xj) < 10 * TOL


@pytest.mark.parametrize("schwarz", ["jacobi", "asm", "none"])
def test_other_variants_converge(problem, schwarz):
    p = problem
    st = DDMSolver(p["H_t"], p["gen_t"], p["tree_t"], schwarz=schwarz, overlap_radius=0.15)
    x, info = st.solve(p["b"], tol=TOL, krylov="gmres", restart=40)
    assert info["Converged"]
    res = np.linalg.norm(p["A"] @ x.numpy() - p["b"]) / np.linalg.norm(p["b"])
    assert res < 10 * TOL


def test_krylov_multi_rhs_against_dense():
    """gmres/cg on a small SPD matrix, two right-hand sides, against numpy."""
    rng = np.random.RandomState(1)
    Q = rng.randn(60, 60)
    A = torch.as_tensor(Q @ Q.T + 60 * np.eye(60))
    B = torch.as_tensor(rng.randn(60, 2))
    want = np.linalg.solve(A.numpy(), B.numpy())
    for solver in (gmres, cg):
        res = solver(lambda v: A @ v, B, tol=1e-10, maxiter=200)
        assert res.converged and res.iterations > 0
        np.testing.assert_allclose(res.x.numpy(), want, rtol=1e-7, atol=1e-9)


def test_unported_solver_options_raise(problem):
    p = problem
    # every local solver of the reference is ported (the BLR ones are held
    # against it in test_torch_ddm_blr.py); one neither package has raises
    with pytest.raises(ValueError, match="local solver"):
        DDMSolver(p["H_t"], p["gen_t"], p["tree_t"], local_solver="lu")
