"""Block GMRES when the block loses rank: ``_block_qr`` on blocks with
repeated, zero and nearly dependent columns, and the complex block solve
that raised in the Cholesky of the old Gram-based QR (the benchmark cell
``complex_block8_stream`` at its CPU size: n = 1,500 points on the unit
sphere, leaf 64, 8 partitions, overlap 0.1, 8 point sources on the sphere
of radius 2), replicated and through the distributed solver's mesh."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import htool_tpu_torch as ht
import torch_parity  # noqa: F401  (asks the port for the CPU)
from htool_tpu_torch.hmatrix.linalg import prepare_tiled_matvec
from htool_tpu_torch.parallel import build_distributed_hmatrix, default_mesh
from htool_tpu_torch.solvers import DDMSolver, DistributedDDMSolver
from htool_tpu_torch.solvers.krylov import _block_qr, _dots
from htool_tpu_torch.testing import laplace_kernel_complex_symmetric
from htool_tpu_torch.utils import profiling

DTYPES = [torch.float32, torch.float64, torch.complex64, torch.complex128]


def _random(n, k, dtype, g):
    x = torch.randn(n, k, generator=g, dtype=torch.float64)
    if dtype.is_complex:
        x = x + 1j * torch.randn(n, k, generator=g, dtype=torch.float64)
    return x


def _block(case, dtype, n=700, mu=8):
    """``(W, zero_columns)``: W in ``dtype``, and how many columns of Q the
    case must deflate."""
    g = torch.Generator().manual_seed(1)
    W = _random(n, mu, dtype, g)
    zeros = 0
    if case == "repeated":
        W[:, 3] = W[:, 1]
        zeros = 1
    elif case == "zero":
        W[:, 2] = 0
        W[:, 5] = 0
        zeros = 2
    elif case == "combination":  # a column in the span of two others
        W[:, 6] = 3 * W[:, 1] - 2 * W[:, 2]
        zeros = 1
    elif case == "rank_two":
        W = _random(n, 2, dtype, g) @ _random(mu, 2, dtype, g).mT
        zeros = mu - 2
    elif case == "nearly_dependent":  # a column 1e-5 off another: kept
        W[:, 4] = W[:, 0] + 1e-5 * _random(n, 1, dtype, g)[:, 0]
    elif case == "graded":  # column norms from 1 to 1e-12: scale is not rank
        W = W * torch.logspace(0, -12, mu, dtype=torch.float64)
    elif case == "ill_conditioned":  # singular values 1 to 1e-4 in mixed directions
        U, _ = torch.linalg.qr(_random(n, mu, dtype, g))
        V, _ = torch.linalg.qr(_random(mu, mu, dtype, g))
        W = U @ torch.diag(torch.logspace(0, -4, mu, dtype=torch.float64)).to(U.dtype) @ V
    return W.to(dtype), zeros


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", ["independent", "repeated", "zero", "combination", "rank_two",
                                  "nearly_dependent", "graded", "ill_conditioned"])
def test_block_qr_rank_deficient(case, dtype):
    W, zeros = _block(case, dtype)
    _, _, gram = _dots(None)
    Q, R, lost = _block_qr(W, gram)
    assert Q.dtype == dtype and R.dtype in (torch.float64, torch.complex128)
    assert bool(torch.isfinite(Q).all()) and bool(torch.isfinite(R).all())
    eps = torch.finfo(dtype).eps
    Wd, Qd = W.to(R.dtype), Q.to(R.dtype)
    # W = Q R to W's rounding, column by column: Q is rounded once to W's
    # dtype (one eps), and a deflated column's remainder is zero here or at
    # rounding level (exact dependence)
    err = torch.linalg.vector_norm(Wd - Qd @ R, dim=0)
    assert bool(torch.all(err <= 8 * eps * torch.linalg.vector_norm(Wd, dim=0))), err
    nonzero = torch.linalg.vector_norm(Qd, dim=0) > 0
    assert int((~nonzero).sum()) == zeros
    Qn = Qd[:, nonzero]
    # the kept columns orthonormal to W's rounding (Q's rounding to W's dtype)
    assert float(torch.linalg.matrix_norm(Qn.mH @ Qn - torch.eye(Qn.shape[1], dtype=R.dtype))) \
        <= 8 * eps
    # a zero column of Q carries no row of R
    assert not bool(R[~nonzero].abs().any())
    # lost rank: a column deflated, or a pivot below what a Gram matrix in
    # W's own dtype resolves (the graded block's columns are independent)
    assert bool(lost) == (case not in ("independent", "graded")
                          and not (case in ("nearly_dependent", "ill_conditioned")
                                   and dtype in (torch.float64, torch.complex128)))


def test_block_qr_all_zero():
    _, _, gram = _dots(None)
    Q, R, lost = _block_qr(torch.zeros(50, 4, dtype=torch.complex64), gram)
    assert bool(lost) and not Q.abs().any() and not R.abs().any()


# ---------------------------------------------------------------------------
# the complex block solve of the benchmark's CPU size

N, LEAF, PARTS, OVERLAP, NRHS = 1500, 64, 8, 0.1, 8
TOL, RESTART = 1e-6, 50
EPSILON, ETA = 1e-3, 100.0


def make_sphere():
    """Uniform points on the unit sphere and 8 right-hand sides, each the
    potential 1/(4π‖x − s‖) of a source s on the sphere of radius 2 times a
    phase, as the benchmark makes them; the kernel matrix in complex128."""
    rng = np.random.default_rng(20261018)
    u, v = rng.random((2, N))
    th, ph = 2 * np.pi * u, np.arccos(2 * v - 1)
    pts = np.stack([np.cos(th) * np.sin(ph), np.sin(th) * np.sin(ph), np.cos(ph)], 1)
    pts = pts.astype(np.float32)
    src = rng.standard_normal((NRHS, 3))
    src *= 2.0 / np.linalg.norm(src, axis=1, keepdims=True)
    x = torch.as_tensor(pts, dtype=torch.float64)
    r = torch.cdist(x, torch.as_tensor(src))
    B = (torch.polar(torch.ones(NRHS, dtype=torch.float64),
                     torch.as_tensor(2 * np.pi * rng.random(NRHS))) / (4 * math.pi * r))
    P = torch.as_tensor(pts)
    gen = ht.KernelGenerator(laplace_kernel_complex_symmetric, P, P)
    tree = ht.build_cluster_tree(pts.astype(np.float64), max_leaf_size=LEAF, n_partitions=PARTS)
    A = laplace_kernel_complex_symmetric(x[:, None, :], x[None, :, :])
    return dict(pts=pts, gen=gen, tree=tree, A=A, B=B.to(torch.complex64))


@pytest.fixture(scope="module")
def sphere():
    return make_sphere()


def _held_to_dense(s, x, H_x):
    """Each bound with its reason.  ``H_x``: the solve's operator applied
    to x.  Returns the true residual against the dense kernel matrix."""
    A, B = s["A"], s["B"].to(torch.complex128)
    x = x.to(torch.complex128)
    bn = torch.linalg.vector_norm(B, dim=0)
    res_A = torch.linalg.vector_norm(B - A @ x, dim=0) / bn
    res_H = torch.linalg.vector_norm(B - H_x.to(torch.complex128), dim=0) / bn
    compression = torch.linalg.vector_norm(A @ x - H_x.to(torch.complex128), dim=0) / bn
    # the solve met its tolerance on its own operator; the stopping test reads
    # the preconditioned residual, so the true one may sit above tol by the
    # preconditioner's conditioning: allow 2x
    assert float(res_H.max()) <= 2 * TOL, res_H
    # the compression's error on this x: eps = 1e-3 is a bound on each block's
    # relative error; on a smooth solution the product errs far less
    assert float(compression.max()) <= EPSILON, compression
    # the triangle inequality, exactly: ‖b − A x‖ ≤ ‖b − H x‖ + ‖(A − H) x‖
    assert bool(torch.all(res_A <= res_H + compression + 1e-12))
    # so the true residual is within the tolerance plus the compression's
    # error; the dense complex128 solve of the same system meets it too
    x_dense = torch.linalg.solve(A, B)
    res_dense = torch.linalg.vector_norm(B - A @ x_dense, dim=0) / bn
    assert float(res_dense.max()) <= 1e-12
    assert float(res_A.max()) <= 2 * TOL + float(compression.max())
    return float(res_A.max())


def test_complex_block_solve_reaches_its_tolerance(sphere):
    """The solve that raised ``linalg.cholesky ... not positive-definite``
    reaches its tolerance in one cycle, and the blocks that lost rank in
    complex64 are counted once each, at the solve's last read."""
    s = sphere
    H = ht.build_hmatrix(s["gen"], s["tree"], epsilon=EPSILON, eta=ETA, symmetry="S", UPLO="L")
    prepare_tiled_matvec(H)
    solver = DDMSolver(H, s["gen"], s["tree"], schwarz="asm", overlap_radius=OVERLAP)
    before = profiling.counters()
    x, infos = solver.solve(s["B"], tol=TOL, maxiter=200, krylov="block_gmres", restart=RESTART)
    after = profiling.counters()
    assert infos["Converged"] and 0 < infos["Nb_it"] < RESTART
    assert x.dtype == torch.complex64 and bool(torch.isfinite(x).all())
    _held_to_dense(s, x, H @ x)
    lost, syncs = (after.get(k, 0) - before.get(k, 0) for k in ("krylov_block_rank_deficient", "syncs"))
    # one QR a step and one a cycle's start; this block of 8 sources loses
    # rank in complex64 before it converges
    assert 1 <= lost <= infos["Nb_it"] + 1
    # the tally adds no host read: the stopping test once a step, the cycle's
    # residual and the last read
    assert syncs == infos["Nb_it"] + 3


def test_distributed_complex_block_solve(sphere):
    """The same solve through the distributed solver: ``gram`` sums over
    the mesh's partitions, and the same QR reaches the same tolerance."""
    s = sphere
    mesh = default_mesh(PARTS, device="cpu")
    dop = build_distributed_hmatrix(s["gen"], s["tree"], mesh, epsilon=EPSILON, eta=ETA)
    solver = DistributedDDMSolver(dop, s["gen"], s["tree"], schwarz="asm", overlap_radius=OVERLAP)
    x, infos = solver.solve(s["B"], tol=TOL, maxiter=200, krylov="block_gmres", restart=RESTART)
    assert infos["Converged"] and 0 < infos["Nb_it"] < RESTART
    assert bool(torch.isfinite(x).all())
    _held_to_dense(s, x, dop @ x)
