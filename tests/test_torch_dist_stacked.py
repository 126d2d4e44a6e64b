"""The distributed layer's batched passes over the local partitions.

- The stacked BLR local solver (``solvers/dist_ddm.py``: ``StackedBLRFactors``,
  ``_stack_blr_factors``, ``_blr_local_solve``) against the JAX package's,
  on subdomains factored by the JAX package and carried across with
  ``convert.blr_from_numpy`` (f64 and c128, k = 1 and 3, to 1e-12), and
  against the port's own ``blr_solve`` of each subdomain, with subdomains of
  different cell sizes, cell counts and rank slices so that every kind of
  padding is exercised.
- The distributed products, one launch per bucket term over the blocks of
  all local partitions: g2g N/T/C and l2l N/T equal the sums of the
  per-partition block-row products (``_local(i)`` views through
  ``linalg.matvec``) to 1e-12, for the plain, symmetric "S"/"L" and
  hermitian "H"/"L" block rows; the wrappers are called once per bucket
  term whatever the number of partitions.
- ``DistributedDDMSolver(local_solver="blr")`` takes the dense local
  solves' iteration count; the dense local mode's solve (a row gather and
  two triangular solves) equals ``torch.linalg.lu_solve``.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import htool_tpu as hj
import htool_tpu.solvers.dist_ddm as dj
from htool_tpu.hmatrix import blr as jb
from htool_tpu.parallel import build_distributed_hmatrix as j_build_distributed
from htool_tpu.parallel import default_mesh as j_default_mesh
from htool_tpu.solvers.ddm import build_geometric_overlap as j_overlap
from htool_tpu.testing import create_sphere, grid_laplacian
from htool_tpu.testing import kernels as kj
import htool_tpu_torch as ht
import htool_tpu_torch.hmatrix.linalg as linalg
from htool_tpu_torch.convert import blr_from_numpy, distributed_from_numpy, tree_from_numpy
from htool_tpu_torch.hmatrix.blr import blr_solve
from htool_tpu_torch.parallel import (
    build_distributed_from_local_hmatrices,
    build_distributed_hmatrix,
    default_mesh,
)
from htool_tpu_torch.solvers import DistributedDDMSolver, build_geometric_overlap
from htool_tpu_torch.solvers.dist_ddm import (
    StackedBLRFactors,
    _blr_local_solve,
    _lu_apply,
    _pivot_permutation,
    _stack_blr_factors,
    _subdomain_blr_factors,
    build_halo_exchange,
)
from htool_tpu_torch.testing import kernels as kt
from torch_parity import blr_to_numpy, distributed_to_numpy, tree_fields

KERNELS = {"f64": "laplace_kernel_symmetric", "c128": "laplace_kernel_complex_symmetric"}
DTYPES = {"f64": torch.float64, "c128": torch.complex128}
TOL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _rhs(shape, kind, seed):
    rng = np.random.RandomState(seed)
    r = rng.randn(*shape)
    return r + 1j * rng.randn(*shape) if kind == "c128" else r


# ----------------------------------------------------------------------
# the stacked BLR local solver
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_subdomains():
    """Per kind: the JAX package's factored BLR matrices of the two
    subdomains (interior + overlap) of a sphere, with cell sizes 32 and 64,
    and the same factors carried across."""
    n = 1000
    pts = create_sphere(n)
    tree = hj.ClusterTreeBuilder(max_leaf_size=40, backend="python").build(pts, n_partitions=2)
    ov = j_overlap(tree, 0.1)
    halo = dj.build_halo_exchange(tree, ov)
    offs, sizes = tree.partition_offsets_sizes()
    out = {}
    for kind, kern in KERNELS.items():
        gen = hj.KernelGenerator(getattr(kj, kern), pts, pts)
        F_j = []
        for p, block in ((0, 32), (1, 64)):
            idx = np.concatenate([np.arange(offs[p], offs[p] + sizes[p]), ov[p]])
            sub = tree.permutation[idx]
            sub_tree = hj.ClusterTreeBuilder(max_leaf_size=block, backend="python").build(
                pts[sub])
            B = jb.build_blr(hj.KernelGenerator(getattr(kj, kern), pts[sub], pts[sub]),
                             sub_tree, epsilon=1e-8, block_size=block)
            F_j.append(jb.blr_lu(B, auto_escalate=0, error_estimate=False))
        F_t = [blr_from_numpy(blr_to_numpy(F), device="cpu") for F in F_j]
        out[kind] = dict(F_j=F_j, F_t=F_t, n_ext_max=int(halo.n_ext_max),
                         ext_sizes=np.asarray(halo.ext_sizes))
    return out


@pytest.mark.parametrize("kind", ["f64", "c128"])
def test_stacked_factors_are_the_reference_stack(jax_subdomains, kind):
    c = jax_subdomains[kind]
    F_t = c["F_t"]
    assert len({F.b for F in F_t}) == 2 and len({F.nL for F in F_t}) == 2
    want = dj._stack_blr_factors(c["F_j"], c["n_ext_max"])
    got = _stack_blr_factors(F_t, c["n_ext_max"])
    assert isinstance(got, StackedBLRFactors) and got.D.dtype == DTYPES[kind]
    assert (got.B, got.nL, got.Rh) == (want.B, want.nL, want.Rh)
    for name in ("D", "U", "V", "pad_idx", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    # torch's pivots are 1-based, the JAX package's 0-based
    np.testing.assert_array_equal(got.piv.numpy() - 1, np.asarray(want.piv))
    # pads of cells2ext read the trash row (zero) here, cell 0 there
    for p, n_ext in enumerate(c["ext_sizes"]):
        np.testing.assert_array_equal(got.cells2ext[p, :n_ext].numpy(),
                                      np.asarray(want.cells2ext)[p, :n_ext])
        assert np.all(got.cells2ext[p, n_ext:].numpy() == got.nL * got.B)
    for tabs_t, tabs_j in ((got.fwd, want.fwd), (got.bwd, want.bwd)):
        for a, b in zip(tabs_t, tabs_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("kind", ["f64", "c128"])
def test_stacked_solve_against_the_reference(jax_subdomains, kind, k):
    """One application on all partitions against the JAX package's
    ``_blr_local_solve`` of each partition's slice of its own stack."""
    c = jax_subdomains[kind]
    sf_j = dj._stack_blr_factors(c["F_j"], c["n_ext_max"])
    sf = _stack_blr_factors(c["F_t"], c["n_ext_max"])
    r = _rhs((2, c["n_ext_max"], k), kind, seed=k)
    z = _blr_local_solve(sf, torch.as_tensor(r)).numpy()
    for p, n_ext in enumerate(c["ext_sizes"]):
        args = [getattr(sf_j, name)[p] for name in ("D", "U", "V", "piv", "pad_idx", "mask",
                                                     "cells2ext")]
        want = np.asarray(dj._blr_local_solve(sf_j, *args, tuple(a[p] for a in sf_j.fwd),
                                              tuple(a[p] for a in sf_j.bwd), r[p]))
        np.testing.assert_allclose(z[p, :n_ext], want[:n_ext], rtol=1e-12,
                                   atol=1e-12 * np.abs(want[:n_ext]).max())
        assert np.all(z[p, n_ext:] == 0)


@pytest.fixture(scope="module")
def port_subdomains():
    """Per (kind, P): the port's factored subdomains of a sphere, each
    partition with its own cell size, so that b, nL and R_half differ."""
    pts = create_sphere(1500)
    cache = {}

    def get(kind, P):
        if (kind, P) not in cache:
            tree = ht.build_cluster_tree(pts, max_leaf_size=40, n_partitions=P)
            gen = ht.KernelGenerator(getattr(kt, KERNELS[kind]), pts, pts, dtype=DTYPES[kind])
            ov = build_geometric_overlap(tree, 0.1)
            halo = build_halo_exchange(tree, ov)
            blocks = (32, 64, 48, 40)
            factors = [F for p in range(P)
                       for F in _subdomain_blr_factors(gen, tree, ov, [p], 1e-8, blocks[p])]
            cache[kind, P] = (factors, halo)
        return cache[kind, P]

    return get


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("kind", ["f64", "c128"])
def test_stacked_solve_against_blr_solve(port_subdomains, kind, P):
    factors, halo = port_subdomains(kind, P)
    assert len({F.b for F in factors}) > 1 and len({F.nL for F in factors}) > 1
    assert len({F.R_half for F in factors}) > 1
    assert all(int(F.U.shape[0]) > 1 for F in factors)  # low-rank cells in every subdomain
    sf = _stack_blr_factors(factors, halo.n_ext_max)
    assert sf.B == max(F.b for F in factors) and sf.nL == max(F.nL for F in factors)
    for k in (1, 3):
        r = torch.as_tensor(_rhs((P, halo.n_ext_max, k), kind, seed=10 + k))
        z = _blr_local_solve(sf, r)
        for p, F in enumerate(factors):
            n_ext = int(halo.ext_sizes[p])
            want = blr_solve(F, r[p, :n_ext], user_numbering=True)
            np.testing.assert_allclose(z[p, :n_ext].numpy(), want.numpy(), rtol=1e-12,
                                       atol=1e-12 * float(want.abs().max()))
            assert bool((z[p, n_ext:] == 0).all())


def test_stacked_factors_cast_once(port_subdomains):
    """A wider right-hand side casts the stacked cells once and keeps them;
    the solve in float64 of float32 factors equals blr_solve's."""
    factors, halo = port_subdomains("f64", 2)
    f32 = [dataclasses.replace(F, D=F.D.float(), U=F.U.float(), V=F.V.float(), cache={})
           for F in factors]
    sf = _stack_blr_factors(f32, halo.n_ext_max)
    assert sf.D.dtype == torch.float32
    r = torch.as_tensor(_rhs((2, halo.n_ext_max, 2), "f64", seed=3))
    z = _blr_local_solve(sf, r)
    cast = sf.cells(torch.float64)
    assert cast[0].dtype == torch.float64 and sf.cells(torch.float64)[0] is cast[0]
    for p, F in enumerate(f32):
        n_ext = int(halo.ext_sizes[p])
        want = blr_solve(F, r[p, :n_ext], user_numbering=True)
        assert want.dtype == torch.float64
        np.testing.assert_allclose(z[p, :n_ext].numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(want.abs().max()))


# ----------------------------------------------------------------------
# the products: one launch per bucket term over all local partitions
# ----------------------------------------------------------------------

PRODUCT_CASES = {"f64": ("N", "f64"), "c128": ("N", "c128"), "S-L": ("S", "f64"),
                 "H-L": ("H", "c128")}


@pytest.fixture(scope="module")
def operators():
    n = 800
    pts = create_sphere(n)
    cache = {}

    def get(case, P):
        if (case, P) not in cache:
            sym, kind = PRODUCT_CASES[case]
            kern = kt.laplace_kernel_hermitian if sym == "H" else getattr(kt, KERNELS[kind])
            gen = ht.KernelGenerator(kern, pts, pts, dtype=DTYPES[kind])
            tree = ht.build_cluster_tree(pts, max_leaf_size=40, n_partitions=P)
            mesh = default_mesh(P, device="cpu")
            if sym == "N":
                D = build_distributed_hmatrix(gen, tree, mesh, epsilon=1e-6, eta=10.0)
            else:
                rows = [ht.HMatrixBuilder(epsilon=1e-6, eta=10.0, symmetry=sym, UPLO="L",
                                          partition_number_for_symmetry=p).build(
                                              gen, tree, target_partition=p)
                        for p in range(P)]
                D = build_distributed_from_local_hmatrices(rows, tree, mesh, symmetry=sym,
                                                           UPLO="L")
            cache[case, P] = (D, kind)
        return cache[case, P]

    return get


def _per_partition(D, x, op, local_in):
    """The sum of the per-partition block-row products (the layout of
    ``_product``): 'N' stacks the local rows, 'T'/'C' sums the global
    outputs."""
    Pl, m = D.mesh.n_local, D.m_loc_max
    if op == "N":
        return torch.cat([linalg.matvec(D._local(i), x, "N") for i in range(Pl)])
    xs = local_in.reshape(Pl, m, -1)
    return sum(linalg.matvec(D._local(i), xs[i], op) for i in range(Pl))


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("case", list(PRODUCT_CASES))
def test_folded_products_equal_the_per_partition_products(operators, case, P):
    D, kind = operators(case, P)
    N = D.shape[0]
    perm = D.perm_t
    for k in (1, 3):
        x = torch.as_tensor(_rhs((N, k), kind, seed=k))
        xc = x[perm]
        x_loc = D.to_local_layout(xc)
        for op in ("N", "T", "C"):
            y_ref = _per_partition(D, xc, op, x_loc)
            want_g2g = y_ref[D._compact_idx] if op == "N" else y_ref
            got = D.matvec(x, op=op)[perm]
            np.testing.assert_allclose(got.numpy(), want_g2g.numpy(), rtol=1e-12,
                                       atol=1e-12 * float(want_g2g.abs().max()))
            if op == "C":
                continue
            got_l = D.matvec_local(x_loc, op=op)
            want_l = (y_ref if op == "N" else
                      torch.cat([y_ref, torch.zeros_like(y_ref[:1])])[D._pad_idx])
            np.testing.assert_allclose(got_l.numpy(), want_l.numpy(), rtol=1e-12,
                                       atol=1e-12 * float(want_l.abs().max()))


@pytest.mark.parametrize("P", [2, 4, 8])
def test_one_wrapper_call_per_bucket_term(operators, monkeypatch, P):
    """A product calls the rows-2/3 wrappers once per bucket term, whatever
    the number of local partitions (the plain versions run here, on the
    CPU, through the same wrappers)."""
    calls = []

    def counted(fn):
        def wrapper(*a, **kw):
            calls.append(int(a[0].shape[0]))
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(linalg, "dense_bucket_matvec", counted(linalg.dense_bucket_matvec))
    monkeypatch.setattr(linalg, "lr_bucket_matvec", counted(linalg.lr_bucket_matvec))
    for case in ("f64", "S-L"):
        D, _ = operators(case, P)
        buckets = D.dense_buckets + D.lr_buckets
        x = torch.as_tensor(_rhs((D.shape[0], 2), "f64", seed=P))
        for op in ("N", "T"):
            terms = sum(len(linalg._bucket_terms(b, op, D.symmetry)) for b in buckets)
            for product in (lambda: D.matvec(x, op=op),
                            lambda: D.matvec_local(D.to_local_layout(x), op=op)):
                calls.clear()
                product()
                assert len(calls) == terms, (case, op, len(calls), terms)
                # each call covers the blocks of all P partitions
                assert calls == [P * _nb(b) for b in buckets
                                 for _ in linalg._bucket_terms(b, op, D.symmetry)]


def _nb(bucket):
    """Blocks of one partition's slice of a distributed bucket."""
    return int((bucket.data if hasattr(bucket, "data") else bucket.U).shape[1])


# ----------------------------------------------------------------------
# the solve
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def grid_case():
    """The case of ``test_torch_dist_ddm.py``: a JAX-built tree and operator
    of the 8×8×6 grid Laplacian on 4 partitions, carried across."""
    pts, A = grid_laplacian((8, 8, 6))
    A = np.asarray(A)
    tree_j = hj.ClusterTreeBuilder(max_leaf_size=40, backend="python").build(pts, n_partitions=4)
    gen_j = hj.MatrixGenerator(A)
    dop_j = j_build_distributed(gen_j, tree_j, j_default_mesh(4), epsilon=1e-10, eta=10.0)
    tree = tree_from_numpy(tree_fields(tree_j))
    return dict(A=A, tree_j=tree_j, gen_j=gen_j, dop_j=dop_j, tree=tree,
                gen=ht.MatrixGenerator(A), dop=distributed_from_numpy(distributed_to_numpy(dop_j)),
                overlap=build_geometric_overlap(tree, 1.5),
                b=np.random.RandomState(1).randn(A.shape[0]))


def test_blr_local_solver_keeps_the_dense_count(grid_case):
    """The stacked BLR local solves take the dense local solves' iteration
    count (``test_torch_dist_ddm.py::test_blr_local_solver``)."""
    c = grid_case
    _, i_dense = DistributedDDMSolver(c["dop"], c["gen"], c["tree"], schwarz="ras",
                                      overlap=c["overlap"]).solve(c["b"], tol=TOL, maxiter=500)
    s = DistributedDDMSolver(c["dop"], c["gen"], c["tree"], schwarz="ras", overlap=c["overlap"],
                             local_solver="blr", blr_epsilon=1e-8, blr_block_size=64)
    assert isinstance(s._sf, StackedBLRFactors) and s._sf.D.shape[0] == 4
    x, infos = s.solve(c["b"], tol=TOL, maxiter=500)
    assert infos["Converged"] and infos["Nb_it"] == i_dense["Nb_it"], (infos, i_dense)
    assert infos["BLR_cells"] == s._sf.nL >= 1
    assert _rel(c["A"] @ x.numpy(), c["b"]) < 100 * TOL


@pytest.mark.parametrize("kind", ["f64", "c128"])
def test_dense_local_apply_is_lu_solve(kind):
    """The dense local mode's row gather + two triangular solves give
    ``torch.linalg.lu_solve``'s result on the same factors."""
    A = torch.as_tensor(_rhs((4, 90, 90), kind, seed=5))
    lu, piv = torch.linalg.lu_factor(A)
    perm = _pivot_permutation(piv)
    assert perm.dtype == torch.int64 and bool((perm.sort(dim=1).values
                                               == torch.arange(90)).all())
    for k in (1, 3):
        r = torch.as_tensor(_rhs((4, 90, k), kind, seed=k))
        want = torch.linalg.lu_solve(lu, piv, r)
        np.testing.assert_allclose(_lu_apply(lu, perm, r).numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(want.abs().max()))


def test_dense_local_factors_cast_once(grid_case):
    """A float64 solve on a float32 operator casts the local LU factors once
    and keeps them; the count is the float64 operator's."""
    c = grid_case
    d32 = distributed_from_numpy({**distributed_to_numpy(c["dop_j"]), "dense_buckets": [
        dict(b, data=np.asarray(b["data"], np.float32))
        for b in distributed_to_numpy(c["dop_j"])["dense_buckets"]], "lr_buckets": [
        dict(b, U=np.asarray(b["U"], np.float32), V=np.asarray(b["V"], np.float32))
        for b in distributed_to_numpy(c["dop_j"])["lr_buckets"]]})
    gen32 = ht.MatrixGenerator(c["A"].astype(np.float32))
    s = DistributedDDMSolver(d32, gen32, c["tree"], schwarz="ras", overlap=c["overlap"])
    assert set(s._lu) == {torch.float32}
    x, infos = s.solve(c["b"], tol=TOL, maxiter=500)
    assert x.dtype == torch.float64 and set(s._lu) == {torch.float32, torch.float64}
    _, i64 = DistributedDDMSolver(c["dop"], c["gen"], c["tree"], schwarz="ras",
                                  overlap=c["overlap"]).solve(c["b"], tol=TOL, maxiter=500)
    assert infos["Converged"] and infos["Nb_it"] == i64["Nb_it"]
