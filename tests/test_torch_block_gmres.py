"""block_gmres of the port against the JAX package's: the same operator and
right-hand sides (NumPy, from a seed) through both, real and complex, bare
and inside ``DDMSolver(krylov="block_gmres")``.

Tolerances: both run the same arithmetic in float64 / complex128, so the
iteration counts are equal and the solutions agree to 1e-6 relative (the
solves stop at 1e-8 to 1e-10, and differ by the rounding of two LAPACK
builds)."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

import htool_tpu as hj
import htool_tpu_torch as ht
from htool_tpu.solvers import DDMSolver as JaxDDMSolver
from htool_tpu.solvers.krylov import block_gmres as jax_block_gmres
from htool_tpu.testing import create_sphere
from htool_tpu.testing import kernels as kernels_jax
from htool_tpu_torch.convert import tree_from_numpy
from htool_tpu_torch.hmatrix.linalg import prepare_tiled_matvec
from htool_tpu_torch.solvers import DDMSolver, block_gmres, gmres
from htool_tpu_torch.testing import kernels as kernels_torch
from torch_parity import tree_fields


def _matrix(n, complex_, seed):
    rng = np.random.RandomState(seed)
    A = rng.randn(n, n) / np.sqrt(n) + 3.0 * np.eye(n)
    if complex_:
        A = A + 1j * rng.randn(n, n) / np.sqrt(n)
    return A


def _rhs(n, mu, complex_, seed):
    rng = np.random.RandomState(seed)
    B = rng.randn(n, mu)
    return B + 1j * rng.randn(n, mu) if complex_ else B


def _both(A, B, Minv=None, **kw):
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    Mt = Mj = None
    if Minv is not None:
        Mit, Mij = torch.as_tensor(Minv), jnp.asarray(Minv)
        Mt, Mj = (lambda v: Mit @ v), (lambda v: Mij @ v)
    rt = block_gmres(lambda v: At @ v, torch.as_tensor(B), M=Mt, **kw)
    rj = jax_block_gmres(lambda v: Aj @ v, jnp.asarray(B), M=Mj, **kw)
    return rt, rj


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("mu", [1, 4])
@pytest.mark.parametrize("precond", [False, True], ids=["bare", "left-preconditioned"])
def test_block_gmres_parity(complex_, mu, precond):
    n = 120
    A, B = _matrix(n, complex_, 1), _rhs(n, mu, complex_, 2)
    Minv = np.diag(1.0 / np.diag(A)) if precond else None
    rt, rj = _both(A, B, Minv, tol=1e-9, maxiter=100, restart=20)
    assert rt.iterations == int(rj.iterations) > 0
    assert rt.converged and bool(rj.converged)
    xt, xj = rt.x.numpy(), np.asarray(rj.x)
    assert np.linalg.norm(xt - xj) / np.linalg.norm(xj) < 1e-6
    want = np.linalg.solve(A, B)
    assert np.linalg.norm(xt - want) / np.linalg.norm(want) < 1e-7
    assert rt.residual < 1e-7 and abs(rt.residual - float(rj.residual)) < 1e-8


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_block_gmres_restarts_and_maxiter(complex_):
    """A restart shorter than the solve needs several cycles; maxiter counts
    block iterations and cuts both packages at the same one."""
    n = 150
    A, B = _matrix(n, complex_, 3), _rhs(n, 3, complex_, 4)
    rt, rj = _both(A, B, tol=1e-10, maxiter=100, restart=4)
    assert rt.iterations == int(rj.iterations) > 4
    assert rt.converged
    assert np.linalg.norm(rt.x.numpy() - np.asarray(rj.x)) / np.linalg.norm(rj.x) < 1e-6
    rt, rj = _both(A, B, tol=1e-14, maxiter=3, restart=20)
    assert rt.iterations == int(rj.iterations) == 3
    assert not rt.converged and not bool(rj.converged)
    assert np.linalg.norm(rt.x.numpy() - np.asarray(rj.x)) / np.linalg.norm(rj.x) < 1e-6


def test_block_gmres_shares_one_subspace():
    """With mu right-hand sides the block method needs fewer operator
    applications than gmres's per-column subspaces, and x0 is honoured."""
    n, mu = 96, 8
    A, B = _matrix(n, True, 5), _rhs(n, mu, True, 6)
    At = torch.as_tensor(A)
    calls = []

    def op(v):
        calls.append(v.shape[1])
        return At @ v

    rb = block_gmres(op, torch.as_tensor(B), tol=1e-8, maxiter=100, restart=30)
    rg = gmres(lambda v: At @ v, torch.as_tensor(B), tol=1e-8, maxiter=100, restart=30)
    assert rb.converged and rg.converged and 0 < rb.iterations < rg.iterations
    assert set(calls) == {mu}
    want = np.linalg.solve(A, B)
    assert np.linalg.norm(rb.x.numpy() - want) / np.linalg.norm(want) < 1e-6
    r0 = block_gmres(op, torch.as_tensor(B), x0=torch.as_tensor(want), tol=1e-8, maxiter=100)
    assert r0.iterations == 1 and r0.converged  # as the reference: a cycle takes one step


@pytest.mark.parametrize("dtype", [np.float32, np.complex64], ids=["float32", "complex64"])
def test_block_gmres_single_precision(dtype):
    """Single-precision vectors: the solution keeps the working dtype, the
    small problems run in double, and tol = 1e-5 is reached."""
    n, mu = 200, 4
    A = _matrix(n, dtype == np.complex64, 9).astype(dtype)
    B = _rhs(n, mu, dtype == np.complex64, 10).astype(dtype)
    At = torch.as_tensor(A)
    res = block_gmres(lambda v: At @ v, torch.as_tensor(B), tol=1e-5, maxiter=60, restart=20)
    assert res.converged and res.x.dtype == At.dtype and 0 < res.iterations < 20
    want = np.linalg.solve(A.astype(np.complex128), B.astype(np.complex128))
    assert np.linalg.norm(res.x.numpy() - want) / np.linalg.norm(want) < 1e-4
    rj = jax_block_gmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(B), tol=1e-5, maxiter=60,
                         restart=20)
    assert abs(res.iterations - int(rj.iterations)) <= 1
    assert np.linalg.norm(res.x.numpy() - np.asarray(rj.x)) / np.linalg.norm(want) < 1e-4


def test_block_gmres_refuses_a_vector():
    with pytest.raises(ValueError, match="2-D"):
        block_gmres(lambda v: v, torch.zeros(5))


# ---------------------------------------------------------------------------
# DDMSolver(krylov="block_gmres") on H-matrices, real and complex

N, P = 1200, 4


def _ddm_problem(kernel_name, symmetry, UPLO):
    pts = create_sphere(N)
    tree_j = hj.ClusterTreeBuilder(max_leaf_size=64, backend="python").build(pts, n_partitions=P)
    tree_t = tree_from_numpy(tree_fields(tree_j))
    gen_j = hj.KernelGenerator(getattr(kernels_jax, kernel_name), pts, pts)
    gen_t = ht.KernelGenerator(getattr(kernels_torch, kernel_name), pts, pts)
    kw = dict(epsilon=1e-5, eta=10.0, symmetry=symmetry, UPLO=UPLO)
    H_j = hj.build_hmatrix(gen_j, tree_j, **kw)
    H_t = ht.build_hmatrix(gen_t, tree_t, **kw)
    return dict(tree_j=tree_j, tree_t=tree_t, gen_j=gen_j, gen_t=gen_t, H_j=H_j, H_t=H_t,
                A=gen_t.to_dense().numpy())


@pytest.fixture(scope="module", params=[
    ("laplace_kernel_symmetric", "N", "N"),
    ("laplace_kernel_complex_symmetric", "N", "N"),
    ("laplace_kernel_hermitian", "H", "L"),
], ids=["real", "complex-symmetric", "hermitian"])
def ddm_problem(request):
    return _ddm_problem(*request.param)


@pytest.mark.parametrize("planned", [False, True], ids=["unplanned", "planned"])
def test_ddm_block_gmres_parity(ddm_problem, planned):
    p = ddm_problem
    for b in p["H_t"].dense_buckets + p["H_t"].lr_buckets:
        b.plan_t = b.plan_s = b.pair = None
    if planned:
        prepare_tiled_matvec(p["H_t"])
    is_complex = p["H_t"].dtype.is_complex
    B = _rhs(N, 4, is_complex, 7)
    tol = 1e-8
    st = DDMSolver(p["H_t"], p["gen_t"], p["tree_t"], schwarz="ras", overlap_radius=0.15)
    xt, it = st.solve(B, tol=tol, krylov="block_gmres", restart=20)
    assert it["Converged"] and it["Krylov"] == "block_gmres" and it["Nb_it"] > 0
    A = p["A"]
    # held to the dense oracle: the H-matrix carries epsilon = 1e-5
    want = np.linalg.solve(A, B)
    assert np.linalg.norm(xt.numpy() - want) / np.linalg.norm(want) < 1e-3
    res = np.linalg.norm(A @ xt.numpy() - B) / np.linalg.norm(B)
    assert res < 1e-4
    sj = JaxDDMSolver(p["H_j"], p["gen_j"], p["tree_j"], schwarz="ras", overlap_radius=0.15)
    xj, ij = sj.solve(B, tol=tol, krylov="block_gmres", restart=20)
    assert it["Nb_it"] == ij["Nb_it"]
    assert np.linalg.norm(xt.numpy() - np.asarray(xj)) / np.linalg.norm(np.asarray(xj)) < 1e-6


def test_ddm_gmres_complex_parity(ddm_problem):
    """The per-column gmres of both packages on the same complex (or real)
    operator: same iteration count, same solution."""
    p = ddm_problem
    for b in p["H_t"].dense_buckets + p["H_t"].lr_buckets:
        b.plan_t = b.plan_s = b.pair = None
    B = _rhs(N, 2, p["H_t"].dtype.is_complex, 8)
    st = DDMSolver(p["H_t"], p["gen_t"], p["tree_t"], schwarz="ras", overlap_radius=0.15)
    sj = JaxDDMSolver(p["H_j"], p["gen_j"], p["tree_j"], schwarz="ras", overlap_radius=0.15)
    xt, it = st.solve(B, tol=1e-8, krylov="gmres", restart=30)
    xj, ij = sj.solve(B, tol=1e-8, krylov="gmres", restart=30)
    assert it["Converged"] and it["Nb_it"] == ij["Nb_it"] > 0
    assert np.linalg.norm(xt.numpy() - np.asarray(xj)) / np.linalg.norm(np.asarray(xj)) < 1e-6
