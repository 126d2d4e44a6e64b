"""Parity of the port's generator, batched partial ACA and bucketed assembly
with the JAX package (both at float64)."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

import htool_tpu as hj
import htool_tpu.testing as kj
import htool_tpu_torch as ht
import htool_tpu_torch.testing as kt
import torch_parity  # noqa: F401  (asks the port for the CPU)
from htool_tpu.testing import create_sphere
from htool_tpu_torch.generator import TransposedGenerator


@pytest.mark.parametrize(
    "name",
    ["laplace_kernel", "laplace_kernel_complex", "laplace_kernel_symmetric",
     "laplace_kernel_complex_symmetric", "laplace_kernel_hermitian", "helmholtz"],
)
def test_kernel_generator_block_parity(name):
    tgt = create_sphere(300, seed=1)
    src = create_sphere(250, seed=2)
    if name == "helmholtz":
        fj, ft = kj.helmholtz_kernel(5.0), kt.helmholtz_kernel(5.0)
    else:
        fj, ft = getattr(kj, name), getattr(kt, name)
    gj = hj.KernelGenerator(fj, tgt, src)
    gt = ht.KernelGenerator(ft, tgt, src)
    rng = np.random.RandomState(0)
    rows = rng.randint(0, 300, (3, 4, 17))
    cols = rng.randint(0, 250, (3, 4, 23))
    a = np.asarray(gj.block(jnp.asarray(rows), jnp.asarray(cols)))
    b = gt.block(rows, cols).numpy()
    assert a.dtype == b.dtype and a.shape == b.shape == (3, 4, 17, 23)
    np.testing.assert_allclose(b, a, rtol=1e-14, atol=0)
    # broadcast batch dims and the un-batched full block
    np.testing.assert_allclose(
        gt.block(rows[0, 0][None, :], cols[0]).numpy(),
        np.asarray(gj.block(jnp.asarray(rows[0, 0][None, :]), jnp.asarray(cols[0]))),
        rtol=1e-14, atol=0,
    )
    np.testing.assert_allclose(gt.to_dense().numpy(), np.asarray(gj.to_dense()), rtol=1e-14, atol=0)


def test_kernel_generator_chunked_block(monkeypatch):
    """Evaluation in bounded chunks gives the same entries as one shot."""
    import htool_tpu_torch.generator as G

    pts = create_sphere(200)
    gt = ht.KernelGenerator(kt.laplace_kernel_symmetric, pts, pts)
    rows = np.random.RandomState(1).randint(0, 200, (5, 40))
    full = gt.block(rows, rows).numpy()
    whole = gt.to_dense().numpy()
    monkeypatch.setattr(G, "_CHUNK_BYTES", 2000)
    np.testing.assert_array_equal(gt.block(rows, rows).numpy(), full)
    np.testing.assert_array_equal(gt.to_dense().numpy(), whole)


def test_matrix_and_transposed_generators():
    A = np.random.RandomState(0).randn(30, 20)
    g = ht.MatrixGenerator(A)
    rows, cols = np.array([[1, 5, 7]]), np.array([[0, 19]])
    np.testing.assert_array_equal(g.block(rows, cols).numpy(), A[np.ix_(rows[0], cols[0])][None])
    gT = TransposedGenerator(g)
    assert gT.shape == (20, 30)
    np.testing.assert_array_equal(gT.block(cols, rows).numpy(), A[np.ix_(rows[0], cols[0])].T[None])


def test_batched_partial_aca_parity():
    """Same admissible rows/cols: both packages reconstruct under eps
    (errors compared, not ranks — pivots depend on rounding)."""
    pts = create_sphere(1200)
    tree = ht.ClusterTreeBuilder(max_leaf_size=48).build(pts)
    plan = ht.plan_block_tree(tree, epsilon=1e-5, eta=10.0)
    leaves = [l for l in plan.admissible if l.t_size <= 64 and l.s_size <= 64][:40]
    assert len(leaves) >= 8
    from htool_tpu_torch.hmatrix.assembly import _block_indices

    t_off = np.array([l.t_off for l in leaves]); s_off = np.array([l.s_off for l in leaves])
    t_sz = np.array([l.t_size for l in leaves]); s_sz = np.array([l.s_size for l in leaves])
    rows = _block_indices(tree.permutation, t_off, t_sz, 64)
    cols = _block_indices(tree.permutation, s_off, s_sz, 64)
    eps, rmax = 1e-5, 32
    gj = hj.KernelGenerator(kj.laplace_kernel_symmetric, pts, pts)
    gt = ht.KernelGenerator(kt.laplace_kernel_symmetric, pts, pts)
    Uj, Vj, rj, fj = hj.batched_partial_aca(
        gj, jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32),
        jnp.asarray(t_sz, jnp.int32), jnp.asarray(s_sz, jnp.int32), eps, rmax)
    Ut, Vt, rt, ft = ht.batched_partial_aca(gt, rows, cols, t_sz, s_sz, eps, rmax)
    assert not np.asarray(fj).any() and not ft.any()
    A = gt.block(rows, cols).numpy()
    mask = (np.arange(64)[None, :, None] < t_sz[:, None, None]) & (
        np.arange(64)[None, None, :] < s_sz[:, None, None])
    A = np.where(mask, A, 0)
    for U, V in ((np.asarray(Uj), np.asarray(Vj)), (Ut.numpy(), Vt.numpy())):
        err = np.linalg.norm(U @ V - A, axis=(1, 2)) / np.linalg.norm(A, axis=(1, 2))
        assert err.max() < 4 * eps, err.max()
    assert np.abs(np.asarray(rj) - rt.numpy()).max() <= 1


def _keys(H):
    dense = sorted((b.block_shape, bool(b.mirror), b.n_blocks) for b in H.dense_buckets)
    lr = sorted((b.block_shape, bool(b.mirror)) for b in H.lr_buckets)
    return dense, lr


@pytest.mark.parametrize(
    "symmetry,UPLO,compressor",
    [("N", "N", "partial_aca"), ("S", "L", "sym_partial_aca")],
)
def test_build_hmatrix_parity(symmetry, UPLO, compressor):
    n, eps = 1000, 1e-4
    pts = create_sphere(n)
    tj = hj.ClusterTreeBuilder(max_leaf_size=32, backend="python").build(pts)
    tt = ht.ClusterTreeBuilder(max_leaf_size=32, backend="python").build(pts)
    gj = hj.KernelGenerator(kj.laplace_kernel_symmetric, pts, pts)
    gt = ht.KernelGenerator(kt.laplace_kernel_symmetric, pts, pts)
    kw = dict(epsilon=eps, eta=10.0, symmetry=symmetry, UPLO=UPLO, compressor=compressor)
    Hj = hj.build_hmatrix(gj, tj, **kw)
    Ht = ht.build_hmatrix(gt, tt, **kw)
    assert _keys(Hj) == _keys(Ht)
    assert Hj.info["n_false_positive"] == Ht.info["n_false_positive"]
    A = gt.to_dense().numpy()
    for H in (Hj, Ht):
        assert np.linalg.norm(np.asarray(H.to_dense()) - A) / np.linalg.norm(A) < eps
    ij, it = hj.hmatrix_info(Hj), ht.hmatrix_info(Ht)
    assert it["compression_ratio"] > 1
    assert it["n_dense_blocks"] == ij["n_dense_blocks"]
    assert it["n_low_rank_blocks"] == ij["n_low_rank_blocks"]


def test_unported_options_raise():
    """An unknown compressor raises; the SVD compressor and recompression,
    which raised before they were ported, now build under ε."""
    pts = create_sphere(200)
    tree = ht.ClusterTreeBuilder(max_leaf_size=32).build(pts)
    gen = ht.KernelGenerator(kt.laplace_kernel_symmetric, pts, pts)
    with pytest.raises(ValueError, match="unknown compressor"):
        ht.build_hmatrix(gen, tree, epsilon=1e-3, compressor="nope")
    A = gen.to_dense().numpy()
    for kw in (dict(compressor="svd"), dict(recompress=True)):
        H = ht.build_hmatrix(gen, tree, epsilon=1e-3, **kw)
        assert np.linalg.norm(H.to_dense() - A) / np.linalg.norm(A) < 1e-3
