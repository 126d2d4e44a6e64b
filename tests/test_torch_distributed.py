"""The port's distributed operator against the JAX package's.

A JAX-built ``DistributedHMatrix`` (P ∈ {2, 4} emulated devices, f64 and
complex128) is carried across with ``convert.distributed_from_numpy``; the
port's g2g products (N, T, C) and l2l products (N, T) must equal the JAX
products to rel 1e-12 and the dense oracle's to < 10·ε.  The JAX block rows
of symmetric storage (S/L, S/U real; H/L, H/U complex) are carried across
one by one and wired by the port's ``build_distributed_from_local_hmatrices``
(its bucket stacking and padding), against the JAX package's wiring of the
same block rows.  The port's own builds, with no JAX input, must be within ε
of the dense oracle.  Partitions live in one process (the port's mesh)."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

import htool_tpu as hj
import htool_tpu.parallel as pj
import htool_tpu_torch as ht
import htool_tpu_torch.parallel as pt
from htool_tpu.testing import (
    create_sphere,
    laplace_kernel_complex_symmetric,
    laplace_kernel_hermitian,
    laplace_kernel_symmetric,
)
from htool_tpu_torch.convert import distributed_from_numpy, hmatrix_from_numpy, tree_from_numpy
from htool_tpu_torch import testing as tt
from htool_tpu_torch.testing import grid_laplacian
from torch_parity import distributed_to_numpy, hmatrix_to_numpy, tree_fields

N, EPS = 480, 1e-6
KERNELS = {"f64": laplace_kernel_symmetric, "c128": laplace_kernel_complex_symmetric}
PORT_KERNELS = {"f64": tt.laplace_kernel_symmetric, "c128": tt.laplace_kernel_complex_symmetric,
                "S": tt.laplace_kernel_symmetric, "H": tt.laplace_kernel_hermitian}


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


def _x(n, k, cplx, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, k)
    return x + 1j * rng.randn(n, k) if cplx else x


def _op(A, op):
    return A if op == "N" else (A.T if op == "T" else A.conj().T)


@pytest.fixture(scope="module")
def sphere():
    pts = create_sphere(N)
    return pts


@pytest.fixture(scope="module")
def carried(sphere):
    """(JAX operator, port operator, dense A, tree) per (P, dtype), built once."""
    cache = {}

    def get(P, kind):
        if (P, kind) not in cache:
            tree = hj.ClusterTreeBuilder(max_leaf_size=40, backend="python").build(
                sphere, n_partitions=P)
            gen = hj.KernelGenerator(KERNELS[kind], sphere, sphere)
            Dj = pj.build_distributed_hmatrix(gen, tree, pj.default_mesh(P), epsilon=EPS,
                                              eta=10.0)
            Dt = distributed_from_numpy(distributed_to_numpy(Dj))
            cache[P, kind] = (Dj, Dt, np.asarray(gen.to_dense()), tree)
        return cache[P, kind]

    return get


@pytest.mark.parametrize("kind", ["f64", "c128"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("op", ["N", "T", "C"])
@pytest.mark.parametrize("P", [2, 4])
def test_g2g_parity(carried, P, op, k, kind):
    Dj, Dt, A, _ = carried(P, kind)
    assert Dt.mesh.n_partitions == P and Dt.dtype == (torch.float64 if kind == "f64"
                                                      else torch.complex128)
    x = _x(N, k, kind == "c128", seed=10 + k)
    if k == 1:
        x = x[:, 0]
    want = np.asarray(Dj.matvec(jnp.asarray(x), op=op))
    got = Dt.matvec(x, op=op).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    assert _rel(got, _op(A, op) @ x) < 10 * EPS


@pytest.mark.parametrize("kind", ["f64", "c128"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("op", ["N", "T"])
@pytest.mark.parametrize("P", [2, 4])
def test_l2l_parity(carried, P, op, k, kind):
    Dj, Dt, A, tree = carried(P, kind)
    perm = np.asarray(tree.permutation)
    xc = _x(N, k, kind == "c128", seed=20 + k)
    x_loc = Dt.to_local_layout(torch.as_tensor(xc))
    np.testing.assert_array_equal(x_loc.numpy(), np.asarray(Dj.to_local_layout(jnp.asarray(xc))))
    want = np.asarray(Dj.matvec_local(jnp.asarray(x_loc.numpy()), op=op))
    got = Dt.matvec_local(x_loc, op=op)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    yc = Dt.to_global_layout(got).numpy()
    Ac = A[np.ix_(perm, perm)]
    assert _rel(yc, _op(Ac, op) @ xc) < 10 * EPS


SYM_CASES = [("S", "L", "real"), ("S", "U", "real"), ("H", "L", "complex"), ("H", "U", "complex")]


@pytest.mark.parametrize("sym,UPLO,kind", SYM_CASES, ids=["-".join(c) for c in SYM_CASES])
@pytest.mark.parametrize("P", [2, 4])
def test_symmetric_block_rows_wired(sphere, P, sym, UPLO, kind):
    """Block rows of symmetric storage (partition_number_for_symmetry=p),
    built by the JAX package, carried across and wired by the port; products
    N, T and C equal the JAX wiring's and the dense oracle's."""
    kern = laplace_kernel_hermitian if sym == "H" else laplace_kernel_symmetric
    tree_j = hj.ClusterTreeBuilder(max_leaf_size=40, backend="python").build(
        sphere, n_partitions=P)
    gen = hj.KernelGenerator(kern, sphere, sphere)
    locs = [hj.HMatrixBuilder(epsilon=EPS, eta=10.0, symmetry=sym, UPLO=UPLO,
                              partition_number_for_symmetry=p).build(gen, tree_j,
                                                                     target_partition=p)
            for p in range(P)]
    Dj = pj.build_distributed_from_local_hmatrices(locs, tree_j, pj.default_mesh(P),
                                                   symmetry=sym, UPLO=UPLO)
    tree = tree_from_numpy(tree_fields(tree_j))
    Dt = pt.build_distributed_from_local_hmatrices(
        [hmatrix_from_numpy(hmatrix_to_numpy(h)) for h in locs], tree, pt.default_mesh(P),
        symmetry=sym, UPLO=UPLO)
    assert any(b.mirror for b in Dt.dense_buckets + Dt.lr_buckets)
    A = np.asarray(gen.to_dense())
    x = _x(N, 2, kind == "complex", seed=5)
    for op in ("N", "T", "C"):
        want = np.asarray(Dj.matvec(jnp.asarray(x), op=op))
        got = Dt.matvec(x, op=op).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
        assert _rel(got, _op(A, op) @ x) < 10 * EPS, op
    assert _rel(Dt.to_dense(), A) < EPS


@pytest.mark.parametrize("kind", ["f64", "c128"])
@pytest.mark.parametrize("P", [2, 4])
def test_own_build_vs_dense(sphere, P, kind):
    """The port's build, with no JAX input: within ε of the dense oracle."""
    pts = torch.as_tensor(sphere)
    gen = ht.KernelGenerator(PORT_KERNELS[kind], pts, pts)
    tree = ht.build_cluster_tree(sphere, max_leaf_size=40, n_partitions=P)
    D = pt.build_distributed_hmatrix(gen, tree, pt.default_mesh(P), epsilon=EPS, eta=10.0)
    A = gen.to_dense().numpy()
    assert _rel(D.to_dense(), A) < EPS
    x = _x(N, 2, kind == "c128", seed=6)
    for op in ("N", "T", "C"):
        assert _rel(D.matvec(x, op=op).numpy(), _op(A, op) @ x) < 10 * EPS
    assert all(b.data.shape[0] == P for b in D.dense_buckets)


@pytest.mark.parametrize("sym,UPLO,kind", SYM_CASES, ids=["-".join(c) for c in SYM_CASES])
def test_own_symmetric_build_vs_dense(sphere, sym, UPLO, kind):
    """The port's symmetric build stores less than the full one and keeps
    the oracle's products; a padded block of a mirror bucket points at its
    partition's first row on both sides."""
    pts = torch.as_tensor(sphere)
    gen = ht.KernelGenerator(PORT_KERNELS[sym], pts, pts)
    tree = ht.build_cluster_tree(sphere, max_leaf_size=40, n_partitions=4)
    D = pt.build_distributed_hmatrix(gen, tree, epsilon=EPS, eta=10.0, symmetry=sym, UPLO=UPLO)
    Dfull = pt.build_distributed_hmatrix(gen, tree, epsilon=EPS, eta=10.0)
    A = gen.to_dense().numpy()
    x = _x(N, 2, kind == "complex", seed=7)
    for op in ("N", "T", "C"):
        assert _rel(D.matvec(x, op=op).numpy(), _op(A, op) @ x) < 10 * EPS, op
    info, info_full = (pt.distributed_hmatrix_info(d) for d in (D, Dfull))
    assert info["compression_ratio"] > info_full["compression_ratio"]
    for b in D.dense_buckets + D.lr_buckets:
        pad = b.t_sizes == 0
        offs = np.broadcast_to(D.part_offsets[:, None], pad.shape)[pad]
        assert np.array_equal(b.t_off.numpy()[pad], offs)
        assert np.array_equal(b.s_off.numpy()[pad], offs)


def test_info_matches_reference(carried):
    Dj, Dt, _, _ = carried(4, "f64")
    want = pj.distributed_hmatrix_info(Dj)
    got = pt.distributed_hmatrix_info(Dt)
    assert set(got) == set(want) - {"assembly_walltime", "block_tree_walltime"}
    for key, v in want.items():
        if key in got:
            np.testing.assert_allclose(
                [v[s] for s in ("min", "mean", "max")] if isinstance(v, dict) else v,
                [got[key][s] for s in ("min", "mean", "max")] if isinstance(v, dict) else got[key],
                rtol=1e-12)
    text = pt.print_distributed_hmatrix_information(Dt)
    assert text.startswith("Distributed HMatrix information:") and "compression_ratio" in text


def test_partition_mismatch_raises(sphere):
    pts = torch.as_tensor(sphere)
    gen = ht.KernelGenerator(tt.laplace_kernel_symmetric, pts[:200], pts[:200])
    tree = ht.build_cluster_tree(sphere[:200], max_leaf_size=30, n_partitions=2)
    with pytest.raises(ValueError, match="2 partitions but mesh has 4"):
        pt.build_distributed_hmatrix(gen, tree, pt.default_mesh(4), epsilon=EPS)
    with pytest.raises(ValueError, match="1 local operators for 2 partitions"):
        pt.build_distributed_from_local_hmatrices(
            [ht.build_hmatrix(gen, tree, epsilon=EPS)], tree, pt.default_mesh(2))
    with pytest.raises(ValueError, match="local-to-local"):
        src = ht.build_cluster_tree(sphere[:150], max_leaf_size=30)
        g = ht.KernelGenerator(tt.laplace_kernel_symmetric, pts[:200], pts[:150])
        D = pt.build_distributed_hmatrix(g, tree, epsilon=EPS, source_tree=src)
        D.matvec_local(torch.zeros(D.m_loc_max * 2))
    D = pt.build_distributed_hmatrix(gen, tree, epsilon=EPS)
    with pytest.raises(ValueError, match="operator expects 200"):
        D.matvec(np.zeros(199))
    with pytest.raises(ValueError, match="P_local"):
        D.matvec_local(torch.zeros(7))


def test_default_mesh_device():
    """The mesh takes the package's default device (the CPU in these tests)
    and as many partitions as asked."""
    m = pt.default_mesh(3)
    assert m.device.type == "cpu" and m.n_partitions == m.n_local == 3
    assert pt.default_mesh().n_partitions == 1


def test_local_mode_and_custom_wiring():
    """mode="local": each partition keeps only its diagonal block (the
    block-Jacobi operator); the same block rows wired through
    build_distributed_from_local_hmatrices give the same products, and dense
    block rows (hmatrix_from_dense) wire into the full matrix."""
    P = 4
    pts, A = grid_laplacian((8, 8, 4))
    A = np.asarray(A)
    gen = ht.MatrixGenerator(A)
    tree = ht.build_cluster_tree(pts, max_leaf_size=40, n_partitions=P)
    perm = tree.permutation
    Ac = A[np.ix_(perm, perm)]
    offs, sizes = tree.partition_offsets_sizes()
    Bref = np.zeros_like(Ac)
    for p in range(P):
        o, s = int(offs[p]), int(sizes[p])
        Bref[o : o + s, o : o + s] = Ac[o : o + s, o : o + s]
    dl = pt.build_distributed_hmatrix(gen, tree, epsilon=1e-10, mode="local")
    assert np.linalg.norm(dl.to_dense(user_numbering=False) - Bref) < 1e-10 * np.linalg.norm(Bref)
    b = ht.HMatrixBuilder(epsilon=1e-10, eta=10.0)
    dc = pt.build_distributed_from_local_hmatrices(
        [b.build(gen, tree, tree, target_partition=p, source_partition=p) for p in range(P)], tree)
    x = np.random.default_rng(0).standard_normal(A.shape[0])
    np.testing.assert_allclose(dc.matvec(x).numpy(), dl.matvec(x).numpy(), rtol=1e-14, atol=1e-14)
    locs = [ht.hmatrix_from_dense(Ac[int(offs[p]) : int(offs[p] + sizes[p])], tree,
                                  target_partition=p) for p in range(P)]
    dd = pt.build_distributed_from_local_hmatrices(locs, tree)
    np.testing.assert_allclose(dd.matvec(x).numpy(), A @ x, atol=1e-10)
