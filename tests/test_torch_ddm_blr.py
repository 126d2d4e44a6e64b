"""DDM with compressed local solves in the port against the JAX package, in
float64: the setting of the JAX package's ``test_ddm_with_blr_local_solver``
(tests/test_blr.py:159-187: the 9 × 9 × 6 grid Laplacian, 4 partitions, RAS
overlap radius 1.5, BLR local factorizations at ε = 1e-8, block 64) through
``DDMSolver(local_solver="blr")`` and, with a coarse size small enough that
every subdomain takes the two-level format, ``local_solver="blr2"``, in both
packages: equal GMRES iteration counts, true residuals below 10·tol, and —
for ``"blr"`` — within 2 iterations of dense local solves, as the JAX test
holds.  The two-level format compresses every off-diagonal panel pair by
partial ACA, which stops early on the grid's sparse panel blocks (most
likely at a zero pivot), so in both packages its local matrices are 5 – 11 %
off and ``"blr2"`` takes 12 iterations where dense local solves take 7; only
the parity is held there."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import htool_tpu as hj
import htool_tpu_torch as ht
from htool_tpu.solvers import DDMSolver as JaxDDMSolver
from htool_tpu.testing import grid_laplacian
from htool_tpu_torch.convert import hmatrix_from_numpy, tree_from_numpy
from htool_tpu_torch.hmatrix.blr import BLRMatrix
from htool_tpu_torch.hmatrix.blr2 import TwoLevelBLR
from htool_tpu_torch.solvers import BLRSchwarzPreconditioner, DDMSolver
from torch_parity import hmatrix_to_numpy, tree_fields

TOL = 1e-6
COARSE = 64  # subdomains hold ~200 points: more than 2·COARSE takes blr2


@pytest.fixture(scope="module")
def grid():
    pts, A = grid_laplacian((9, 9, 6))
    tree_j = hj.ClusterTreeBuilder(max_leaf_size=40, backend="python").build(pts, n_partitions=4)
    gen_j = hj.MatrixGenerator(A)
    H_j = hj.build_hmatrix(gen_j, tree_j, epsilon=1e-10, eta=10.0)
    return dict(A=A, tree_j=tree_j, tree_t=tree_from_numpy(tree_fields(tree_j)), gen_j=gen_j,
                gen_t=ht.MatrixGenerator(A, device="cpu"), H_j=H_j,
                H_t=hmatrix_from_numpy(hmatrix_to_numpy(H_j), device="cpu"),
                b=np.random.RandomState(0).randn(A.shape[0]))


def _kw(local_solver):
    return dict(schwarz="ras", overlap_radius=1.5, local_solver=local_solver, blr_epsilon=1e-8,
                blr_block_size=64, blr_coarse_size=COARSE)


@pytest.mark.parametrize("local_solver", ["blr", "blr2"])
def test_ddm_blr_local_solver_parity(grid, local_solver):
    g = grid
    s_j = JaxDDMSolver(g["H_j"], g["gen_j"], g["tree_j"], **_kw(local_solver))
    s_t = DDMSolver(g["H_t"], g["gen_t"], g["tree_t"], **_kw(local_solver))
    assert isinstance(s_t.precond, BLRSchwarzPreconditioner)
    want = TwoLevelBLR if local_solver == "blr2" else BLRMatrix
    assert all(isinstance(F, want) and F.factorized for F in s_t.precond.factors)
    assert s_t.precond.memory_bytes() > 0
    x_j, i_j = s_j.solve(g["b"], tol=TOL, maxiter=300, krylov="gmres")
    x_t, i_t = s_t.solve(g["b"], tol=TOL, maxiter=300, krylov="gmres")
    assert i_t["Converged"] and i_t["Nb_it"] == i_j["Nb_it"] > 0
    assert {k: i_t[k] for k in ("Local_solver", "Precond", "Nb_subdomains")} \
        == {k: i_j[k] for k in ("Local_solver", "Precond", "Nb_subdomains")}
    assert set(i_t) == set(i_j)
    A, b = g["A"], g["b"]
    for x in (np.asarray(x_j), x_t.numpy()):
        assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 10 * TOL
    if local_solver == "blr2":
        return
    # compressed local solves behave like dense ones iteration-wise
    _, i_d = DDMSolver(g["H_t"], g["gen_t"], g["tree_t"], schwarz="ras",
                       overlap_radius=1.5).solve(g["b"], tol=TOL, maxiter=300, krylov="gmres")
    assert abs(i_t["Nb_it"] - i_d["Nb_it"]) <= 2
