"""The port's H-matrix conversion and factorization surface
(``hmatrix/conversion.py``) against the JAX package's, in float64 and
complex128: a JAX-assembled H-matrix (symmetry N, S or H) and its cluster
tree are carried across, then ``to_blr``, ``recompress_hmatrix``,
``retile_blr``/``permute_blr``, ``blr_matmul`` and
``blr_triangular_solve_matrix`` on mixed grids, ``hmatrix_hmatrix_product``
over mixed trees and ``blr_to_hmatrix`` (whose product runs the port's
unplanned path) run in both packages (the factorization surface is
``test_torch_factorization.py``).  Tolerances: 1e-10 between the packages,
and the reference's oracles (tests/test_conversion.py)."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import htool_tpu as hj
import htool_tpu_torch as ht
from htool_tpu.hmatrix import blr as jb
from htool_tpu.testing import create_sphere
from htool_tpu.testing import kernels as kernels_jax
from htool_tpu_torch.convert import hmatrix_from_numpy, tree_from_numpy
from htool_tpu_torch.hmatrix import blr as tb
from htool_tpu_torch.hmatrix import conversion as tc
from htool_tpu_torch.hmatrix.linalg import matvec_user
from htool_tpu_torch.testing import laplace_kernel_symmetric as kernel_torch
from torch_parity import hmatrix_to_numpy, tree_fields

PARITY = 1e-10


def rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


def _tree(pts, leaf, **kw):
    tree_j = hj.ClusterTreeBuilder(max_leaf_size=leaf, backend="python", **kw).build(pts)
    return tree_j, tree_from_numpy(tree_fields(tree_j))


def _hcase(n=1200, eps=1e-5, symmetry="N", kernel="laplace_kernel_symmetric", leaf=40):
    pts = create_sphere(n)
    tree_j, tree_t = _tree(pts, leaf)
    gen_j = hj.KernelGenerator(getattr(kernels_jax, kernel), pts, pts)
    kw = dict(symmetry=symmetry, UPLO="L") if symmetry != "N" else {}
    H_j = hj.build_hmatrix(gen_j, tree_j, epsilon=eps, eta=10.0, **kw)
    Pm = tree_j.permutation
    A = np.asarray(gen_j.to_dense())
    return dict(H_j=H_j, H_t=hmatrix_from_numpy(hmatrix_to_numpy(H_j), device="cpu"),
                tree_j=tree_j, tree_t=tree_t, gen_j=gen_j, A=A, Ac=A[np.ix_(Pm, Pm)], n=n,
                pts=pts)


@pytest.mark.parametrize("symmetry,kernel", [("N", "laplace_kernel_symmetric"),
                                             ("S", "laplace_kernel_symmetric"),
                                             ("H", "laplace_kernel_hermitian")])
def test_to_blr_parity(symmetry, kernel):
    c = _hcase(symmetry=symmetry, kernel=kernel)
    B_j = hj.to_blr(c["H_j"], c["tree_j"], block_size=80, epsilon=1e-10)
    B_t = tc.to_blr(c["H_t"], c["tree_t"], block_size=80, epsilon=1e-10)
    np.testing.assert_array_equal(B_t.cls, B_j.cls)
    np.testing.assert_array_equal(B_t.ranks.numpy(), np.asarray(B_j.ranks))
    assert B_t.R_half == B_j.R_half and B_t.compression_info()["n_lr_cells"] > 0
    assert rel(B_t.to_dense(), B_j.to_dense()) < PARITY
    # the symmetric / hermitian storage is expanded: the whole operator
    assert rel(B_t.to_dense(), c["H_t"].to_dense(user_numbering=False)) < 1e-9
    assert rel(B_t.to_dense(), c["Ac"]) < 1e-4


def test_recompress_hmatrix_parity():
    c = _hcase(eps=1e-8)
    H2_j = hj.recompress_hmatrix(c["H_j"], 1e-4)
    H2_t = tc.recompress_hmatrix(c["H_t"], 1e-4)
    for b_t, b_j in zip(H2_t.lr_buckets, H2_j.lr_buckets):
        np.testing.assert_array_equal(b_t.ranks, np.asarray(b_j.ranks))
        assert b_t.U.shape == tuple(b_j.U.shape)
    r_old = sum(int(np.asarray(b.ranks).sum()) for b in c["H_t"].lr_buckets)
    assert sum(int(b.ranks.sum()) for b in H2_t.lr_buckets) < r_old
    D_t = H2_t.to_dense(user_numbering=False)
    assert rel(D_t, H2_j.to_dense(user_numbering=False)) < PARITY
    assert rel(D_t, c["Ac"]) < 1e-3


def test_to_blr_partition_restricted():
    """A partition's block row converts to the BLR of its diagonal square
    (tests/test_conversion.py:150), which factorizes."""
    n, P = 1200, 4
    pts = create_sphere(n)
    tree_j = hj.ClusterTreeBuilder(max_leaf_size=50, backend="python").build(pts, n_partitions=P)
    tree_t = tree_from_numpy(tree_fields(tree_j))
    gen_j = hj.KernelGenerator(kernels_jax.laplace_kernel_symmetric, pts, pts)
    Pm = tree_j.permutation
    Adc = np.asarray(gen_j.to_dense())[np.ix_(Pm, Pm)]
    offs, szs = tree_j.partition_offsets_sizes()
    p = P - 1
    H_j = hj.build_hmatrix(gen_j, tree_j, epsilon=1e-8, eta=10.0, target_partition=p)
    Bp = tc.to_blr(hmatrix_from_numpy(hmatrix_to_numpy(H_j), device="cpu"), tree_t,
                   block_size=100, epsilon=1e-8)
    r0, m = int(offs[p]), int(szs[p])
    Dref = Adc[r0 : r0 + m, r0 : r0 + m]
    assert rel(Bp.to_dense(), hj.to_blr(H_j, tree_j, block_size=100, epsilon=1e-8).to_dense()) \
        < PARITY
    assert rel(Bp.to_dense(), Dref) < 1e-6
    x = np.random.RandomState(p).randn(m)
    sol = tb.blr_solve(tb.blr_lu(Bp, error_estimate=False), torch.as_tensor(Dref @ x)).numpy()
    assert rel(sol, x) < 1e-5


@pytest.fixture(scope="module")
def grids():
    """Two BLR grids of one operator (blocks 75 and 150), both packages."""
    n = 1200
    pts = create_sphere(n)
    tree_j, tree_t = _tree(pts, 50)
    gen_j = hj.KernelGenerator(kernels_jax.laplace_kernel_symmetric, pts, pts)
    gen_t = ht.KernelGenerator(kernel_torch, pts, pts)
    Pm = tree_j.permutation
    out = dict(Adc=np.asarray(gen_j.to_dense())[np.ix_(Pm, Pm)])
    for blk in (75, 150):
        out[f"j{blk}"] = jb.build_blr(gen_j, tree_j, epsilon=1e-8, eta=10.0, block_size=blk)
        out[f"t{blk}"] = tb.build_blr(gen_t, tree_t, epsilon=1e-8, eta=10.0, block_size=blk)
    return out


def test_retile_and_matmul_mixed_grids(grids):
    """Operands on different grids re-tile onto a common grid
    (tests/test_conversion.py:96)."""
    A_t, B_t = grids["t75"], grids["t150"]
    assert A_t.nL != B_t.nL
    Ar_t = tc.retile_blr(A_t, B_t.cell_off, B_t.cell_size, b=B_t.b)
    Ar_j = hj.retile_blr(grids["j75"], np.asarray(grids["j150"].cell_off),
                         np.asarray(grids["j150"].cell_size), b=grids["j150"].b)
    assert rel(Ar_t.to_dense(), Ar_j.to_dense()) < PARITY
    assert rel(Ar_t.to_dense(), grids["Adc"]) < 1e-6
    C_t = tb.blr_matmul(A_t, B_t)
    C_j = jb.blr_matmul(grids["j75"], grids["j150"])
    assert rel(C_t.to_dense(), C_j.to_dense()) < PARITY
    assert rel(C_t.to_dense(), grids["Adc"] @ grids["Adc"]) < 1e-5


def test_triangular_solve_matrix_mixed_grids(grids):
    """(tests/test_conversion.py:122): the compressed right-hand side is
    re-tiled onto the factor's grid."""
    F_t = tb.blr_lu(grids["t150"], error_estimate=False)
    F_j = jb.blr_lu(grids["j150"], error_estimate=False)
    X_t = tb.blr_triangular_solve_matrix(F_t, grids["t75"], which="L", side="L", trans="N")
    X_j = jb.blr_triangular_solve_matrix(F_j, grids["j75"], which="L", side="L", trans="N")
    Ar = tc.retile_blr(grids["t75"], F_t.cell_off, F_t.cell_size, b=F_t.b)
    ref = tb.blr_triangular_solve(F_t, torch.as_tensor(Ar.to_dense()), which="L").numpy()
    assert rel(X_t.to_dense(), ref) < 1e-5
    assert rel(X_t.to_dense(), X_j.to_dense()) < 1e-8
    # side R through the transpose: X·U = B, against the dense right solve
    B = grids["t150"]
    Xr_t = tb.blr_triangular_solve_matrix(F_t, B, which="U", side="R", trans="N")
    ref = tb.blr_triangular_solve(F_t, torch.as_tensor(B.to_dense()), which="U", side="R").numpy()
    assert rel(Xr_t.to_dense(), ref) < 1e-5


def test_permute_blr_roundtrip():
    """(tests/test_conversion.py:210): a BLR matrix re-expressed in another
    tree's numbering, in both packages."""
    n = 1000
    pts = create_sphere(n)
    tree_aj, tree_at = _tree(pts, 50)
    tree_bj, tree_bt = _tree(pts, 80, n_children=3)
    gen_j = hj.KernelGenerator(kernels_jax.laplace_kernel_symmetric, pts, pts)
    gen_t = ht.KernelGenerator(kernel_torch, pts, pts)
    X_j = jb.build_blr(gen_j, tree_bj, epsilon=1e-6, eta=10.0, block_size=80)
    X_t = tb.build_blr(gen_t, tree_bt, epsilon=1e-6, eta=10.0, block_size=80)
    Fa_t = tb.build_blr(gen_t, tree_at, epsilon=1e-6, eta=10.0, block_size=80)
    q = np.argsort(tree_aj.permutation)[tree_bj.permutation]
    Xp_t = tc.permute_blr(X_t, q, Fa_t.cell_off, Fa_t.cell_size, b=Fa_t.b, R_half=Fa_t.R_half)
    Xp_j = hj.permute_blr(X_j, q, np.asarray(Fa_t.cell_off), np.asarray(Fa_t.cell_size),
                          b=Fa_t.b, R_half=Fa_t.R_half)
    np.testing.assert_array_equal(Xp_t.cls, Xp_j.cls)
    assert rel(Xp_t.to_dense(), Xp_j.to_dense()) < PARITY
    Pa = tree_aj.permutation
    assert rel(Xp_t.to_dense(), np.asarray(gen_j.to_dense())[np.ix_(Pa, Pa)]) < 1e-4
    assert (Xp_t.compression_info()["compression_ratio"]
            >= 0.8 * Fa_t.compression_info()["compression_ratio"])


def test_hmatrix_product_mixed_trees():
    """H×H across different cluster trees (tests/test_conversion.py:177)."""
    n = 1000
    pts = create_sphere(n)
    tree_aj, tree_at = _tree(pts, 40)
    tree_bj, tree_bt = _tree(pts, 64, n_children=3)
    gen_j = hj.KernelGenerator(kernels_jax.laplace_kernel_symmetric, pts, pts)
    A_j = hj.build_hmatrix(gen_j, tree_aj, epsilon=1e-7, eta=10.0)
    B_j = hj.build_hmatrix(gen_j, tree_bj, epsilon=1e-7, eta=10.0)
    A_t = hmatrix_from_numpy(hmatrix_to_numpy(A_j), device="cpu")
    B_t = hmatrix_from_numpy(hmatrix_to_numpy(B_j), device="cpu")
    C_j = hj.hmatrix_hmatrix_product(A_j, B_j, tree_aj, epsilon=1e-7, block_size=80,
                                     tree_b=tree_bj)
    C_t = tc.hmatrix_hmatrix_product(A_t, B_t, tree_at, epsilon=1e-7, block_size=80,
                                     tree_b=tree_bt)
    assert rel(C_t.to_dense(), C_j.to_dense()) < PARITY
    Pa = tree_aj.permutation
    Ac = np.asarray(gen_j.to_dense())[np.ix_(Pa, Pa)]
    x = np.random.RandomState(5).randn(n)
    y = tb.blr_matvec(C_t, torch.as_tensor(x)).numpy()
    assert rel(y, Ac @ (Ac @ x)) < 1e-3


def test_blr_to_hmatrix_roundtrip(grids):
    """A BLR matrix with dense and LR cells back as an HMatrix: its product
    runs the port's unplanned bucket path (plain versions on the CPU) and
    equals the BLR product; the JAX package's re-export agrees."""
    B_t = grids["t75"]
    H_t = tc.blr_to_hmatrix(B_t)
    assert H_t.dense_buckets and H_t.lr_buckets
    assert all(b.plan_t is None for b in H_t.dense_buckets + H_t.lr_buckets)
    x = np.random.RandomState(7).randn(B_t.n, 8)
    y = matvec_user(H_t, torch.as_tensor(x)).numpy()
    Pm = B_t.permutation
    ref = np.empty_like(x)
    ref[Pm] = tb.blr_matvec(B_t, torch.as_tensor(x[Pm])).numpy()
    assert rel(y, ref) < 1e-12
    y_j = np.asarray(hj.blr_to_hmatrix(grids["j75"]) @ x)
    assert rel(y, y_j) < PARITY
    with pytest.raises(ValueError):
        tc.blr_to_hmatrix(tb.blr_lu(B_t, error_estimate=False))
