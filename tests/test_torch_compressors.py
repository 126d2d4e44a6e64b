"""The port's full-pivot ACA, truncated SVD and SVD recompression against the
JAX package (f64): the compressors on the same blocks, and whole builds with
``compressor="svd"|"full_aca"`` and ``recompress=True``."""

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
from htool_tpu.hmatrix import compressors as cj
from htool_tpu.testing import create_sphere
from htool_tpu_torch.hmatrix import compressors as ct
from htool_tpu_torch.hmatrix.assembly import _block_indices


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


@pytest.fixture(scope="module")
def blocks():
    """Admissible leaves of a 1200-point sphere, padded to 64: user rows and
    cols, true sizes, and both packages' generators."""
    pts = create_sphere(1200)
    tree = ht.ClusterTreeBuilder(max_leaf_size=48).build(pts)
    plan = ht.plan_block_tree(tree, epsilon=1e-5, eta=10.0)
    leaves = [l for l in plan.admissible if l.t_size <= 64 and l.s_size <= 64][:40]
    t_off = np.array([l.t_off for l in leaves]); s_off = np.array([l.s_off for l in leaves])
    t_sz = np.array([l.t_size for l in leaves]); s_sz = np.array([l.s_size for l in leaves])
    rows = _block_indices(tree.permutation, t_off, t_sz, 64)
    cols = _block_indices(tree.permutation, s_off, s_sz, 64)
    gj = hj.KernelGenerator(kj.laplace_kernel_symmetric, pts, pts)
    gt = ht.KernelGenerator(kt.laplace_kernel_symmetric, pts, pts)
    return rows, cols, t_sz, s_sz, gj, gt


@pytest.mark.parametrize("reqrank", [-1, 5])
@pytest.mark.parametrize("name", ["batched_full_aca", "batched_svd_compress"])
def test_compressor_parity(blocks, name, reqrank):
    """Same blocks: equal ranks and failures, U·V to 1e-10."""
    rows, cols, t_sz, s_sz, gj, gt = blocks
    eps, rmax = 1e-5, 32
    Uj, Vj, rj, fj = getattr(cj, name)(
        gj, jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32),
        jnp.asarray(t_sz, jnp.int32), jnp.asarray(s_sz, jnp.int32), eps, rmax, reqrank)
    Ut, Vt, rt, ft = getattr(ct, name)(gt, rows, cols, t_sz, s_sz, eps, rmax, reqrank)
    assert Ut.shape == Uj.shape and Vt.shape == Vj.shape
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert not ft.any() and int(rt.max()) > 1
    assert _rel((Ut @ Vt).numpy(), np.asarray(Uj) @ np.asarray(Vj)) <= 1e-10


def test_recompress_and_truncation_rank_parity():
    """Blocks of rank 8 stored at rank 24 (and one with fewer valid
    columns): equal new ranks, U·V to 1e-10, and the trailing-energy rank."""
    rng = np.random.RandomState(0)
    nb, m, n, r = 4, 60, 50, 24
    U = np.concatenate([rng.randn(nb, m, 8), 1e-10 * rng.randn(nb, m, r - 8)], axis=2)
    V = np.concatenate([rng.randn(nb, 8, n), 1e-10 * rng.randn(nb, r - 8, n)], axis=1)
    ranks = np.array([r, r, 6, r])
    U2j, V2j, r2j = cj.batched_recompress(jnp.asarray(U), jnp.asarray(V), jnp.asarray(ranks), 1e-6)
    U2t, V2t, r2t = ct.batched_recompress(torch.as_tensor(U), torch.as_tensor(V),
                                          torch.as_tensor(ranks), 1e-6)
    np.testing.assert_array_equal(r2t.numpy(), np.asarray(r2j))
    assert list(r2t.numpy()) == [8, 8, 6, 8]
    assert _rel((U2t @ V2t).numpy(), np.asarray(U2j) @ np.asarray(V2j)) <= 1e-10
    s = np.sort(np.abs(rng.randn(5, 12)), axis=1)[:, ::-1].copy()
    for eps in (1e-1, 1e-3):
        np.testing.assert_array_equal(ct.svd_truncation_rank(torch.as_tensor(s), eps).numpy(),
                                      np.asarray(cj.svd_truncation_rank(jnp.asarray(s), eps)))


@pytest.mark.parametrize("symmetry", ["N", "S"])
@pytest.mark.parametrize("compressor", ["svd", "full_aca"])
def test_build_hmatrix_compressor_parity(compressor, symmetry):
    """build_hmatrix(compressor=..., recompress=True) in both packages on
    the same tree: equal hmatrix_info counts and ranks, to_dense to 1e-10,
    and under ε against the dense matrix."""
    n, eps = 800, 1e-4
    pts = create_sphere(n)
    tj = hj.ClusterTreeBuilder(max_leaf_size=32, backend="python").build(pts)
    tt = ht.ClusterTreeBuilder(max_leaf_size=32).build(pts)
    kw = dict(epsilon=eps, eta=10.0, symmetry=symmetry, UPLO="L" if symmetry == "S" else "N",
              compressor=compressor, recompress=True)
    Hj = hj.build_hmatrix(hj.KernelGenerator(kj.laplace_kernel_symmetric, pts, pts), tj, **kw)
    gt = ht.KernelGenerator(kt.laplace_kernel_symmetric, pts, pts)
    Ht = ht.build_hmatrix(gt, tt, **kw)
    ij, it = hj.hmatrix_info(Hj), ht.hmatrix_info(Ht)
    for key in ("n_dense_blocks", "n_low_rank_blocks", "n_false_positive", "rank_min",
                "rank_max", "rank_mean", "compression_ratio"):
        assert it[key] == ij[key], key
    assert it["n_low_rank_blocks"] > 0
    D = Ht.to_dense()
    assert _rel(D, np.asarray(Hj.to_dense())) <= 1e-10
    A = gt.to_dense().numpy()
    assert _rel(D, A) < eps
