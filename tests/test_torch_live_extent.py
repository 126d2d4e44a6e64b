"""Planned products at each block's live extent, on the CPU.

A symmetric H-matrix of a sphere ('S', 'L': dense diagonal blocks, mirrored
dense and low-rank blocks), in float32, float64, complex64 and complex128,
with the split two-stage plan on every low-rank bucket.  For the stored term
(plan_t) and the mirror term (plan_s) of each bucket:

- each slot's extent is its block's true rows and columns as stored, in the
  plan's sort order (a dense block's ``t_sizes`` x ``s_sizes``; stage by
  stage, V's ``ranks`` x ``s_sizes`` and U's ``t_sizes`` x ``ranks``);
- the plan's count of streamed bytes is each live row's run in whole
  32-byte sectors, panel by panel;
- the product matches the H-matrix's dense export, and does so unchanged when every
  stored entry outside the live extents is NaN (the plain version reads
  what the kernel reads).
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (CPU device, one BLAS thread)

import htool_tpu_torch as ht
from htool_tpu_torch.hmatrix.linalg import matvec_user, prepare_tiled_matvec
from htool_tpu_torch.ops.tiled_matvec import SplitPlan, TilePlan
from htool_tpu_torch.testing import (
    create_sphere,
    fill_padding,
    laplace_kernel_complex_symmetric,
    laplace_kernel_symmetric,
)

N = 1500
DTYPES = ["float32", "float64", "complex64", "complex128"]
TOL = {"float32": 2e-5, "complex64": 2e-5, "float64": 1e-12, "complex128": 1e-12}
_CACHE = {}


def operator(dtype: str):
    """The symmetric H-matrix in ``dtype``, planned (split plans on every
    low-rank bucket)."""
    if dtype not in _CACHE:
        real = np.float32 if dtype in ("float32", "complex64") else np.float64
        kernel = (laplace_kernel_complex_symmetric if "complex" in dtype
                  else laplace_kernel_symmetric)
        pts = torch.as_tensor(create_sphere(N, seed=3).astype(real))
        gen = ht.KernelGenerator(kernel, pts, pts)
        tree = ht.build_cluster_tree(pts.numpy().astype(np.float64), max_leaf_size=40)
        H = ht.build_hmatrix(gen, tree, epsilon=1e-4, eta=2.0, symmetry="S", UPLO="L")
        assert str(H.dtype) == f"torch.{dtype}"
        prepare_tiled_matvec(H)
        _CACHE[dtype] = (H, H.to_dense())  # the compressed operator, in user numbering
    return _CACHE[dtype]


def stages(bucket, side: str):
    """[(plan, rows, cols)] of a bucket term: each launch's plan and the
    true rows and columns of the matrix it streams, per block."""
    plan = bucket.plan_t if side == "t" else bucket.plan_s
    t, s = np.asarray(bucket.t_sizes), np.asarray(bucket.s_sizes)
    if isinstance(bucket, ht.DenseBucket):
        return [(plan, t, s)]
    assert isinstance(plan, SplitPlan)
    r = np.asarray(bucket.ranks)
    u, v = (plan.stage_b, plan.stage_a) if side == "t" else (plan.stage_a, plan.stage_b)
    return [(u, t, r), (v, r, s)]


def terms(dtype: str):
    H, _ = operator(dtype)
    for bucket in H.dense_buckets + H.lr_buckets:
        for side in ("t", "s") if bucket.mirror else ("t",):
            yield bucket, side


@pytest.mark.parametrize("side", ["t", "s"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_slot_extents_are_the_blocks_true_sizes(dtype, side):
    seen = 0
    for bucket, s in terms(dtype):
        if s != side:
            continue
        for plan, rows, cols in stages(bucket, side):
            assert isinstance(plan, TilePlan) and plan.ext is not None
            blk = plan.blk.numpy()
            ext = plan.ext.numpy()
            real = blk >= 0
            b = blk[real] // plan.P
            np.testing.assert_array_equal(ext[real, 0], rows[b])
            np.testing.assert_array_equal(ext[real, 1], cols[b])
            assert not ext[~real].any()
            assert plan.ext_max == (int(rows.max()), int(cols.max()))
            seen += 1
    assert seen >= 2


def _formula(rows, cols, P, cut, trans, item):
    """Bytes of each live row's run in whole 32-byte sectors, panel by panel:
    row panels of a block as stored, or column slabs of it applied
    transposed (a slab's row segment is a run of its own)."""
    total = 0
    for r, c in zip(rows.tolist(), cols.tolist()):
        for p in range(P):
            lo, hi = p * cut, (p + 1) * cut
            if trans:
                w = max(0, min(hi, c) - lo)
                total += r * (-(-w * item // 32) * 32)
            else:
                h = max(0, min(hi, r) - lo)
                total += h * (-(-c * item // 32) * 32)
    return total


@pytest.mark.parametrize("side", ["t", "s"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_streamed_bytes_are_the_live_sectors(dtype, side):
    H, _ = operator(dtype)
    item = torch.empty((), dtype=H.dtype).element_size()
    live = padded = 0
    for bucket, s in terms(dtype):
        if s != side:
            continue
        for plan, rows, cols in stages(bucket, side):
            want = _formula(rows, cols, plan.P, plan.out_w, plan.trans, item)
            assert plan.streamed_bytes() == want
            live += want
            padded += plan.data.numel() * item
    assert 0 < live < padded  # the padding is not streamed


@pytest.mark.parametrize("op", ["N", "T"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_product_at_live_extents_matches_dense(dtype, op):
    H, A = operator(dtype)
    rng = np.random.RandomState(7)
    x = rng.randn(N, 3)
    if "complex" in dtype:
        x = x + 1j * rng.randn(N, 3)
    x = torch.as_tensor(x.astype(A.dtype))
    want = (A if op == "N" else A.T) @ x.numpy()
    got = matvec_user(H, x, op=op).numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= TOL[dtype]
    # NaN in every padded entry: the planned product reads none of it
    Hn = prepare_tiled_matvec(fill_padding(H, float("nan")))
    got_n = matvec_user(Hn, x, op=op).numpy()
    assert np.isfinite(got_n).all()
    np.testing.assert_allclose(got_n, got, rtol=0, atol=1e-12 * np.abs(got).max())


def test_plans_without_sizes_stream_whole_blocks():
    """A bucket that does not know its sizes gets no extents: whole blocks,
    counted whole, in a dense plan and in both stages of a split plan."""
    H, _ = operator("float64")
    b = H.dense_buckets[0]
    bare = ht.DenseBucket(data=b.data, t_off=b.t_off, s_off=b.s_off)
    from htool_tpu_torch.ops.tiled_matvec import build_tile_plan, build_tile_plan_lr_split

    plan = build_tile_plan(bare, "t", H.shape[0] + 256)
    assert plan.ext is None and plan.ext_max == ()
    assert plan.streamed_bytes() == b.data.numel() * 8
    lr = H.lr_buckets[0]
    bare_lr = ht.LowRankBucket(U=lr.U, V=lr.V, t_off=lr.t_off, s_off=lr.s_off)
    split = build_tile_plan_lr_split(bare_lr, "t", H.shape[0] + 4096)
    for st, f in zip(split, (lr.V, lr.U)):  # every row whole, in 32-byte sectors
        nb, rows, cols = f.shape
        assert st.ext is None and st.ext_max == ()
        assert st.streamed_bytes() == nb * rows * (-(-cols * 8 // 32) * 32)
