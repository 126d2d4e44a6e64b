"""Parity of ``SubsetGenerator`` and ``hmatrix_from_dense`` with the JAX
package: the same NumPy inputs through both, exact for the gathers and
1e-12 for the float64 / complex128 products."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

import htool_tpu as hj
import htool_tpu.generator as gj
import htool_tpu.testing as kj
import htool_tpu_torch as ht
import htool_tpu_torch.generator as gt
import htool_tpu_torch.testing as kt
from htool_tpu.testing import create_sphere
from htool_tpu_torch.convert import tree_from_numpy
from htool_tpu_torch.hmatrix.linalg import matvec, matvec_user, prepare_tiled_matvec
from torch_parity import tree_fields

N = 300


@pytest.mark.parametrize("base", ["matrix", "kernel", "complex-kernel"])
@pytest.mark.parametrize("square", [True, False], ids=["rows-only", "rows-and-cols"])
def test_subset_generator_parity(base, square):
    rng = np.random.RandomState(0)
    pts = create_sphere(N)
    if base == "matrix":
        A = rng.randn(N, N)
        bj, bt = gj.MatrixGenerator(jnp.asarray(A)), gt.MatrixGenerator(A)
    else:
        name = "laplace_kernel_symmetric" if base == "kernel" else "laplace_kernel_hermitian"
        bj = gj.KernelGenerator(getattr(kj, name), pts, pts)
        bt = gt.KernelGenerator(getattr(kt, name), pts, pts)
        A = np.asarray(bj.to_dense())
    row_index = rng.permutation(N)[:80]
    col_index = None if square else rng.permutation(N)[:50]
    sj = gj.SubsetGenerator(bj, row_index, col_index)
    st = gt.SubsetGenerator(bt, row_index, col_index)
    assert st.shape == sj.shape == (80, 80 if square else 50)
    assert st.dtype == bt.dtype and st.device == bt.device
    rows = rng.randint(0, st.shape[0], (3, 7))  # batched, local numbering
    cols = rng.randint(0, st.shape[1], (3, 5))
    want = np.asarray(sj.block(jnp.asarray(rows), jnp.asarray(cols)))
    got = st.block(rows, cols).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
    ci = row_index if square else col_index
    np.testing.assert_allclose(got, A[row_index[rows][:, :, None], ci[cols][:, None, :]],
                               rtol=1e-14, atol=0)
    np.testing.assert_allclose(st.to_dense().numpy(), A[np.ix_(row_index, ci)], rtol=1e-14,
                               atol=0)


def test_subset_generator_feeds_assembly():
    """A subset of the sphere assembled through SubsetGenerator is the
    H-matrix of the sub-problem."""
    pts = create_sphere(2 * N)
    keep = np.sort(np.random.RandomState(1).permutation(2 * N)[:N])
    base = gt.KernelGenerator(kt.laplace_kernel_symmetric, pts, pts)
    sub = gt.SubsetGenerator(base, keep)
    tree = ht.build_cluster_tree(pts[keep], max_leaf_size=32)
    H = ht.build_hmatrix(sub, tree, epsilon=1e-5, eta=10.0)
    A = base.to_dense().numpy()[np.ix_(keep, keep)]
    assert np.linalg.norm(H.to_dense() - A) / np.linalg.norm(A) < 1e-5


@pytest.fixture(scope="module")
def trees():
    pts = create_sphere(N)
    tree_j = hj.ClusterTreeBuilder(max_leaf_size=32, backend="python").build(pts, n_partitions=4)
    return tree_j, tree_from_numpy(tree_fields(tree_j))


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("parts", [(-1, -1), (2, -1), (1, 3)],
                         ids=["global", "block-row", "block"])
def test_hmatrix_from_dense_parity(trees, complex_, parts):
    tree_j, tree_t = trees
    tp, sp = parts
    offs, sizes = tree_t.partition_offsets_sizes()
    m = int(sizes[tp]) if tp >= 0 else N
    n = int(sizes[sp]) if sp >= 0 else N
    rng = np.random.RandomState(3)
    A = rng.randn(m, n) + (1j * rng.randn(m, n) if complex_ else 0)
    Hj = hj.hmatrix_from_dense(jnp.asarray(A), tree_j, tp, sp)
    Ht = ht.hmatrix_from_dense(A, tree_t, tp, sp)
    assert Ht.shape == tuple(Hj.shape) and Ht.t_root_off == int(Hj.t_root_off)
    assert Ht.dtype == (torch.complex128 if complex_ else torch.float64)
    bj, bt = Hj.dense_buckets[0], Ht.dense_buckets[0]
    assert bt.block_shape == bj.block_shape and not Ht.lr_buckets
    np.testing.assert_array_equal(bt.data.numpy(), np.asarray(bj.data))
    np.testing.assert_array_equal(bt.t_off.numpy(), np.asarray(bj.t_off))
    np.testing.assert_array_equal(bt.s_off.numpy(), np.asarray(bj.s_off))
    assert Ht.info == Hj.info
    # products in cluster numbering: N on the global x, T/C on the local rows
    for op in ("N", "T", "C"):
        x = rng.randn(N if op == "N" else m, 2) + (1j * rng.randn(N if op == "N" else m, 2)
                                                    if complex_ else 0)
        want = np.asarray(hj.matvec(Hj, jnp.asarray(x), op=op))
        got = matvec(Ht, torch.as_tensor(x), op=op).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
        full = np.zeros((m, N), A.dtype)
        full[:, int(offs[sp]) if sp >= 0 else 0 :][:, :n] = A
        ref = {"N": full, "T": full.T, "C": full.conj().T}[op] @ x
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


def test_hmatrix_from_dense_global_runs_user_numbering_and_plans(trees):
    _, tree_t = trees
    rng = np.random.RandomState(4)
    A = rng.randn(N, N) + 1j * rng.randn(N, N)  # cluster numbering
    H = ht.hmatrix_from_dense(A, tree_t)
    perm = np.asarray(tree_t.permutation)
    Au = np.zeros_like(A)
    Au[np.ix_(perm, perm)] = A
    np.testing.assert_array_equal(H.to_dense(), Au)
    x = rng.randn(N, 2) + 1j * rng.randn(N, 2)
    want = Au.conj().T @ x
    np.testing.assert_allclose(matvec_user(H, x, op="C").numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    prepare_tiled_matvec(H)
    np.testing.assert_allclose(matvec_user(H, x, op="C").numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_hmatrix_from_dense_refuses_wrong_shape(trees):
    _, tree_t = trees
    with pytest.raises(ValueError, match="expected"):
        ht.hmatrix_from_dense(np.zeros((N, N - 1)), tree_t)
