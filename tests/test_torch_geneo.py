"""The GenEO coarse space and the two-level DDM of the port against the JAX
package's, in float64: the same points and the same cluster tree (carried
across with ``tree_from_numpy``) through ``build_geneo_coarse_space`` and
``DDMSolver(coarse=...)`` in both packages.

Eigenvectors are defined only up to a basis (signs, rotations inside a
repeated eigenvalue), so the bases are compared by their per-subdomain
subspaces, ``1 - σ_min(Q₁ᴴQ₂)``; eigenvalues, the basis-free coarse solve
Q r = Z E⁻¹ Z* r and GMRES iteration counts are compared directly."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import htool_tpu as hj
import htool_tpu_torch as ht
from htool_tpu.hmatrix.linalg import matvec as jax_matvec
from htool_tpu.solvers import DDMSolver as JaxDDMSolver
from htool_tpu.solvers import build_geneo_coarse_space as jax_geneo
from htool_tpu.solvers import build_geometric_overlap as jax_overlap
from htool_tpu.testing import create_sphere, grid_laplacian
from htool_tpu.testing import kernels as kernels_jax
from htool_tpu_torch.convert import geneo_from_numpy, hmatrix_from_numpy, tree_from_numpy
from htool_tpu_torch.hmatrix.linalg import matvec, prepare_tiled_matvec
from htool_tpu_torch.solvers import DDMSolver, build_geneo_coarse_space, build_geometric_overlap
from htool_tpu_torch.testing import kernels as kernels_torch
from torch_parity import geneo_to_numpy, hmatrix_to_numpy, tree_fields

TOL = 1e-6
CORRECTIONS = ["additive", "deflated", "balanced"]
INFO_KEYS = ("GenEO_geev_walltime", "GenEO_ZtAZ_walltime", "GenEO_facto_coarse_operator_walltime")


def _case(pts, make_gen_j, make_gen_t, P, leaf, radius, eps, carry_hmatrix=False):
    """The same tree and overlap on both sides, and an H-matrix compressed in
    each package (or, with ``carry_hmatrix``, the JAX one carried across, so
    that E = Z* A Z sees the same operator on both sides)."""
    tree_j = hj.ClusterTreeBuilder(max_leaf_size=leaf, backend="python").build(pts, n_partitions=P)
    tree_t = tree_from_numpy(tree_fields(tree_j))
    gen_j, gen_t = make_gen_j(), make_gen_t()
    H_j = hj.build_hmatrix(gen_j, tree_j, epsilon=eps, eta=10.0)
    H_t = (hmatrix_from_numpy(hmatrix_to_numpy(H_j), device="cpu") if carry_hmatrix
           else ht.build_hmatrix(gen_t, tree_t, epsilon=eps, eta=10.0))
    prepare_tiled_matvec(H_t)
    ov_j, ov_t = jax_overlap(tree_j, radius), build_geometric_overlap(tree_t, radius)
    for a, b in zip(ov_j, ov_t):
        np.testing.assert_array_equal(a, b)
    return dict(tree_j=tree_j, tree_t=tree_t, gen_j=gen_j, gen_t=gen_t, H_j=H_j, H_t=H_t,
                ov_j=ov_j, ov_t=ov_t, A_j=lambda x: jax_matvec(H_j, x, op="N"),
                A_t=lambda x: matvec(H_t, x, op="N"))


def _build_both(c, **kw):
    infos_j, infos_t = {}, {}
    cs_j = jax_geneo(c["gen_j"], c["tree_j"], c["ov_j"], c["A_j"], infos=infos_j, **kw)
    cs_t = build_geneo_coarse_space(c["gen_t"], c["tree_t"], c["ov_t"], c["A_t"],
                                    infos=infos_t, **kw)
    return cs_j, cs_t, infos_j, infos_t


@pytest.fixture(scope="module")
def grid():
    """The grid Laplacian 10×10×8 (800 points), 8 partitions, overlap 1.5,
    ν = 4 — the reference's two-level test case (tests/test_solvers.py)."""
    pts, A = grid_laplacian((10, 10, 8))
    c = _case(pts, lambda: hj.MatrixGenerator(A), lambda: ht.MatrixGenerator(A),
              P=8, leaf=40, radius=1.5, eps=1e-10)
    c["A"] = A
    c["b"] = np.random.RandomState(1).randn(A.shape[0])
    c["r"] = np.random.RandomState(3).randn(A.shape[0], 2)
    c["spaces"] = {store: _build_both(c, nu=4, symmetry="S", store=store)
                   for store in ("replicated", "local")}
    return c


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


def _coarse_blocks(cs, tree):
    """Per partition p: the interior rows of p's own coarse columns."""
    offs, sizes = tree.partition_offsets_sizes()
    nus = np.asarray(cs.nu_per_subdomain)
    if cs.Z is None:
        Z_loc = np.asarray(cs.Z_loc)
        return [Z_loc[p, : sizes[p], : nus[p]] for p in range(len(nus))]
    Z = np.asarray(cs.Z)
    cols = np.concatenate([[0], np.cumsum(nus)])
    return [Z[offs[p] : offs[p] + sizes[p], cols[p] : cols[p + 1]] for p in range(len(nus))]


def _subspace_gap(cs_j, cs_t, tree):
    gaps = []
    for Bj, Bt in zip(_coarse_blocks(cs_j, tree), _coarse_blocks(cs_t, tree)):
        assert Bj.shape == Bt.shape
        q1, q2 = np.linalg.qr(Bj)[0], np.linalg.qr(Bt)[0]
        gaps.append(1 - np.linalg.svd(q1.conj().T @ q2, compute_uv=False).min())
    return max(gaps)


def _check_eigenvalues(cs_j, cs_t, rel=1e-8):
    np.testing.assert_array_equal(cs_j.nu_per_subdomain, cs_t.nu_per_subdomain)
    for ej, et in zip(cs_j.eigenvalues, cs_t.eigenvalues):
        np.testing.assert_allclose(et, ej, rtol=rel)


@pytest.mark.parametrize("store", ["replicated", "local"])
def test_coarse_size_eigenvalues_and_infos(grid, store):
    cs_j, cs_t, infos_j, infos_t = grid["spaces"][store]
    assert cs_t.size == cs_j.size == 32
    _check_eigenvalues(cs_j, cs_t)
    assert infos_t["GenEO_coarse_space_size"] == infos_j["GenEO_coarse_space_size"] == 32
    for key in INFO_KEYS:
        assert key in infos_j and infos_t[key] >= 0.0
    assert set(infos_t) == set(infos_j)


@pytest.mark.parametrize("store", ["replicated", "local"])
def test_subspaces(grid, store):
    cs_j, cs_t, _, _ = grid["spaces"][store]
    assert _subspace_gap(cs_j, cs_t, grid["tree_j"]) < 1e-8


@pytest.mark.parametrize("store", ["replicated", "local"])
def test_coarse_solve(grid, store):
    cs_j, cs_t, _, _ = grid["spaces"][store]
    qj = np.asarray(cs_j.coarse_solve(grid["r"]))
    qt = cs_t.coarse_solve(torch.as_tensor(grid["r"])).numpy()
    assert _rel(qt, qj) < 1e-8
    q1 = cs_t.coarse_solve(torch.as_tensor(grid["r"][:, 0]))
    assert q1.shape == (grid["r"].shape[0],) and _rel(q1.numpy(), qj[:, 0]) < 1e-8


def test_local_store_against_replicated(grid):
    """The local store builds nothing [N, nc]; its Q r and E agree with the
    replicated store's."""
    _, rep, _, _ = grid["spaces"]["replicated"]
    _, loc, _, _ = grid["spaces"]["local"]
    assert loc.Z is None and tuple(loc.Z_loc.shape) == (8, int(loc.row_size.max()), 4)
    assert rep.Z_loc is None and tuple(rep.Z.shape) == (800, 32)
    r = torch.as_tensor(grid["r"])
    assert _rel(loc.coarse_solve(r).numpy(), rep.coarse_solve(r).numpy()) < 1e-10


def _solve_j(c, **kw):
    s = JaxDDMSolver(c["H_j"], c["gen_j"], c["tree_j"], schwarz="ras", overlap=c["ov_j"], **kw)
    x, infos = s.solve(c["b"], tol=TOL, maxiter=500, krylov="gmres")
    return np.asarray(x), infos


def _solve_t(c, **kw):
    s = DDMSolver(c["H_t"], c["gen_t"], c["tree_t"], schwarz="ras", overlap=c["ov_t"], **kw)
    x, infos = s.solve(c["b"], tol=TOL, maxiter=500, krylov="gmres")
    return x.numpy(), infos


def _residual(A, x, b):
    return np.linalg.norm(A @ x - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def grid_iterations(grid):
    """One-level and two-level GMRES iteration counts of both packages."""
    out = {"one_level": (_solve_j(grid)[1]["Nb_it"], _solve_t(grid)[1]["Nb_it"])}
    cs_j, cs_t, _, _ = grid["spaces"]["replicated"]
    for corr in CORRECTIONS:
        xj, ij = _solve_j(grid, coarse=cs_j, coarse_correction=corr)
        xt, it = _solve_t(grid, coarse=cs_t, coarse_correction=corr)
        assert it["Coarse_correction"] == corr and it["Coarse_size"] == 32
        out[corr] = (ij["Nb_it"], it["Nb_it"], _residual(grid["A"], xt, grid["b"]))
    return out


@pytest.mark.parametrize("correction", CORRECTIONS)
def test_iteration_counts(grid_iterations, correction):
    it_j, it_t, res = grid_iterations[correction]
    assert it_t == it_j > 0
    assert res < 10 * TOL


def test_two_levels_beat_one(grid_iterations):
    one_j, one_t = grid_iterations["one_level"]
    assert one_t == one_j
    assert min(grid_iterations[c][1] for c in CORRECTIONS) < one_t, grid_iterations


@pytest.mark.parametrize("store", ["replicated", "local"])
def test_geneo_from_numpy_round_trip(grid, store):
    """A JAX-built coarse space carried across gives the JAX package's Q r
    and, in DDMSolver, its iteration counts."""
    cs_j, _, _, _ = grid["spaces"][store]
    cs = geneo_from_numpy(geneo_to_numpy(cs_j), device="cpu")
    assert cs.size == cs_j.size and (cs.Z is None) == (store == "local")
    qj = np.asarray(cs_j.coarse_solve(grid["r"]))
    assert _rel(cs.coarse_solve(torch.as_tensor(grid["r"])).numpy(), qj) < 1e-12
    _, ij = _solve_j(grid, coarse=cs_j, coarse_correction="deflated")
    _, it = _solve_t(grid, coarse=cs, coarse_correction="deflated")
    assert it["Nb_it"] == ij["Nb_it"]


def test_threshold_selection(grid):
    """threshold= keeps every eigenvalue above it: a varying ν per subdomain."""
    lam = np.unique(np.concatenate(grid["spaces"]["replicated"][1].eigenvalues))
    # halfway across the widest gap between the kept eigenvalues: no λ lies
    # near it, so rounding cannot move one across
    i = int(np.argmax(np.diff(lam)))
    threshold = float(0.5 * (lam[i] + lam[i + 1]))
    cs_j, cs_t, _, _ = _build_both(grid, threshold=threshold, symmetry="S", store="local")
    _check_eigenvalues(cs_j, cs_t)
    assert cs_t.size == cs_j.size == int(np.sum(cs_t.nu_per_subdomain))
    assert all(np.all(e > threshold) for e in cs_t.eigenvalues)
    assert _rel(cs_t.coarse_solve(torch.as_tensor(grid["r"])).numpy(),
                np.asarray(cs_j.coarse_solve(grid["r"]))) < 1e-8


def test_local_B(grid):
    """A user Bᵢ (here Aᵢ plus 0.5 on the diagonal, over [interior; overlap])."""
    offs, sizes = grid["tree_j"].partition_offsets_sizes()
    perm, A = grid["tree_j"].permutation, grid["A"]
    local_B = []
    for p in range(8):
        idx = perm[np.concatenate([np.arange(offs[p], offs[p] + sizes[p]), grid["ov_j"][p]])]
        local_B.append(A[np.ix_(idx, idx)] + 0.5 * np.eye(idx.size))
    cs_j, cs_t, _, _ = _build_both(grid, nu=3, local_B=local_B, symmetry="S")
    _check_eigenvalues(cs_j, cs_t)
    assert _subspace_gap(cs_j, cs_t, grid["tree_j"]) < 1e-8
    assert _rel(cs_t.coarse_solve(torch.as_tensor(grid["r"])).numpy(),
                np.asarray(cs_j.coarse_solve(grid["r"]))) < 1e-8


def test_general_host_evp(grid):
    """symmetry="N": the host ``scipy.linalg.eig`` path; for real input the
    basis is complex, as in the reference."""
    cs_j, cs_t, _, _ = _build_both(grid, nu=4, symmetry="N", store="local")
    assert cs_t.Z_loc.dtype == torch.complex128 and np.asarray(cs_j.Z_loc).dtype == np.complex128
    _check_eigenvalues(cs_j, cs_t)
    assert _subspace_gap(cs_j, cs_t, grid["tree_j"]) < 1e-8
    qt = cs_t.coarse_solve(torch.as_tensor(grid["r"]))
    assert qt.dtype == torch.complex128
    assert _rel(qt.numpy(), np.asarray(cs_j.coarse_solve(grid["r"]))) < 1e-8
    _, ij = _solve_j(grid, coarse=cs_j, coarse_correction="balanced")
    xt, it = _solve_t(grid, coarse=cs_t, coarse_correction="balanced")
    assert it["Nb_it"] == ij["Nb_it"]
    assert _residual(grid["A"], xt, grid["b"]) < 10 * TOL


def test_evp_chunks(grid):
    """A workspace budget of one byte runs one subdomain per chunk (a
    ragged sequence of EVP batches): the same coarse space."""
    _, ref, _, _ = grid["spaces"]["replicated"]
    cs = build_geneo_coarse_space(grid["gen_t"], grid["tree_t"], grid["ov_t"], grid["A_t"],
                                  nu=4, symmetry="S", evp_budget_bytes=1)
    _check_eigenvalues(ref, cs, rel=1e-12)
    r = torch.as_tensor(grid["r"])
    assert _rel(cs.coarse_solve(r).numpy(), ref.coarse_solve(r).numpy()) < 1e-10


def test_indefinite_B_raises_naming_the_subdomain(grid):
    offs, sizes = grid["tree_t"].partition_offsets_sizes()
    local_B = [np.eye(int(sizes[p]) + grid["ov_t"][p].size) for p in range(8)]
    local_B[5][0, 0] = -1.0
    with pytest.raises(RuntimeError, match="subdomain 5"):
        build_geneo_coarse_space(grid["gen_t"], grid["tree_t"], grid["ov_t"], grid["A_t"],
                                 nu=2, local_B=local_B, symmetry="S")


def test_unknown_options_raise(grid):
    _, cs_t, _, _ = grid["spaces"]["replicated"]
    with pytest.raises(ValueError, match="store"):
        build_geneo_coarse_space(grid["gen_t"], grid["tree_t"], grid["ov_t"], grid["A_t"],
                                 store="sharded")
    s = DDMSolver(grid["H_t"], grid["gen_t"], grid["tree_t"], schwarz="ras",
                  overlap=grid["ov_t"], coarse=cs_t, coarse_correction="multiplicative")
    with pytest.raises(ValueError, match="coarse correction"):
        s.solve(grid["b"], tol=TOL)


def _check_degenerate_case(c, cs_j, cs_t, r, corrections):
    """The kernel fixtures' GenEO spectrum is one eigenvalue, 1, of
    multiplicity close to each interior's size (their 1e5 diagonal makes
    DAᵢD and Aᵢ agree on the interior), so any ν eigenvectors of it are a
    right answer and the two packages' bases need not span one space.  What
    is defined is checked: ν and the eigenvalues; that each of the port's
    vectors solves the subdomain's EVP; that its Q is a projector
    (Q A Q r = Q r); and, with the JAX basis carried across, the JAX
    package's Q r and iteration counts."""
    _check_eigenvalues(cs_j, cs_t)
    offs, sizes = c["tree_t"].partition_offsets_sizes()
    perm = c["tree_t"].permutation
    for p, V in enumerate(_coarse_blocks(cs_t, c["tree_t"])):
        idx = torch.as_tensor(perm[np.concatenate([np.arange(offs[p], offs[p] + sizes[p]),
                                                   c["ov_t"][p]])])
        Ai = c["gen_t"].block(idx, idx).numpy()
        sz = int(sizes[p])
        # the interior rows vᵢ of a solution of (D Aᵢ D) v = λ Aᵢ v solve
        # A_II vᵢ = λ S vᵢ, S = A_II - A_IO A_OO⁻¹ A_OI (the overlap rows
        # eliminated)
        A_II, A_IO, A_OI, A_OO = Ai[:sz, :sz], Ai[:sz, sz:], Ai[sz:, :sz], Ai[sz:, sz:]
        S = A_II - A_IO @ np.linalg.solve(A_OO, A_OI)
        lhs = A_II @ V
        assert _rel(lhs, (S @ V) * cs_t.eigenvalues[p][None, :]) < 1e-8
    rt = torch.as_tensor(r)
    q = cs_t.coarse_solve(rt)
    assert _rel(cs_t.coarse_solve(c["A_t"](q)).numpy(), q.numpy()) < 1e-10
    carried = geneo_from_numpy(geneo_to_numpy(cs_j), device="cpu")
    assert _rel(carried.coarse_solve(rt).numpy(), np.asarray(cs_j.coarse_solve(r))) < 1e-10
    for corr in corrections:
        _, ij = _solve_j(c, coarse=cs_j, coarse_correction=corr)
        _, ic = _solve_t(c, coarse=carried, coarse_correction=corr)
        x, it = _solve_t(c, coarse=cs_t, coarse_correction=corr)
        assert ic["Nb_it"] == ij["Nb_it"] > 0
        assert it["Converged"] and it["Coarse_size"] == cs_j.size


def test_sphere_case():
    """The Laplace kernel on a sphere (1,200 points, 4 partitions, overlap
    0.1, ν = 2, local store)."""
    pts = create_sphere(1200)
    c = _case(pts, lambda: hj.KernelGenerator(kernels_jax.laplace_kernel_symmetric, pts, pts),
              lambda: ht.KernelGenerator(kernels_torch.laplace_kernel_symmetric, pts, pts),
              P=4, leaf=64, radius=0.1, eps=1e-6, carry_hmatrix=True)
    c["b"] = np.random.RandomState(2).randn(1200)
    cs_j, cs_t, _, _ = _build_both(c, nu=2, symmetry="S", store="local")
    assert cs_t.size == cs_j.size == 8
    _check_degenerate_case(c, cs_j, cs_t, np.random.RandomState(4).randn(1200, 3),
                           ["additive"])


def test_complex_hermitian_case():
    """A hermitian complex kernel (symmetry "H"): the batched EVP in
    complex128, Z.mH in the coarse solve."""
    pts = create_sphere(600, seed=1)
    c = _case(pts, lambda: hj.KernelGenerator(kernels_jax.laplace_kernel_hermitian, pts, pts),
              lambda: ht.KernelGenerator(kernels_torch.laplace_kernel_hermitian, pts, pts),
              P=4, leaf=48, radius=0.15, eps=1e-8, carry_hmatrix=True)
    rng = np.random.RandomState(5)
    c["b"] = rng.randn(600) + 1j * rng.randn(600)
    cs_j, cs_t, _, _ = _build_both(c, nu=3, symmetry="H")
    assert cs_t.Z.dtype == torch.complex128 and cs_t.size == cs_j.size == 12
    _check_degenerate_case(c, cs_j, cs_t, rng.randn(600, 2) + 1j * rng.randn(600, 2),
                           ["additive", "balanced"])


@pytest.mark.parametrize("shape", [(5, 4, 3), (10, 10, 8)])
def test_grid_laplacian_filled_on_a_device(shape):
    """The two-level grid case's matrix, filled as a tensor on a device (the
    CPU here), equals the JAX package's NumPy matrix."""
    from htool_tpu_torch.testing import grid_laplacian as grid_torch

    pts_j, A_j = grid_laplacian(shape)
    pts_t, A_t = grid_torch(shape, device="cpu")
    assert A_t.dtype == torch.float64 and A_t.device.type == "cpu"
    np.testing.assert_array_equal(A_t.numpy(), A_j)
    np.testing.assert_array_equal(pts_t, pts_j)
    np.testing.assert_array_equal(grid_torch(shape)[1], A_j)
