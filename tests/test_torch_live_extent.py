"""Planned products at each block's live extent, on the CPU.

A symmetric H-matrix of a sphere ('S', 'L': dense diagonal blocks, mirrored
dense and low-rank blocks), in float32, float64, complex64 and complex128,
planned: the diagonal bucket's per-term plans, and each mirror bucket's pair
plan (the block and its mirror in one launch).  For the stored term (side
"t") and the mirror term (side "s") of each bucket, through its per-term
plan (built for a mirror bucket as before the pair pass: the plans it takes
where the pass does not take it), and for each pair plan at k = 1 (side
"t") and k = 8 (side "s"):

- each slot's extent is its block's true rows and columns as stored, in the
  plan's sort order (a dense block's ``t_sizes`` x ``s_sizes``; stage by
  stage, V's ``ranks`` x ``s_sizes`` and U's ``t_sizes`` x ``ranks``); a
  pair plan's items hold each block's true columns and rank, and its rows
  once (a dense block's in panels that tile them);
- the plan's count of streamed bytes is each live row's run in whole
  32-byte sectors, panel by panel (a pair plan's: each live coefficient
  once, a cluster's piece of a V row a run of its own);
- the product matches the H-matrix's dense export, and does so unchanged when every
  stored entry outside the live extents is NaN (the plain version reads
  what the kernel reads).
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (CPU device, one BLAS thread)

import htool_tpu_torch as ht
from htool_tpu_torch.hmatrix.linalg import _pad_in_of, matvec_user, prepare_tiled_matvec
from htool_tpu_torch.ops import pair_matvec as pm
from htool_tpu_torch.ops.tiled_matvec import (
    SplitPlan,
    TilePlan,
    build_tile_plan,
    build_tile_plan_lr_split,
)
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
    """The symmetric H-matrix in ``dtype``, planned (a pair plan on every
    mirror bucket, split plans on the other low-rank buckets)."""
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


_PER_TERM = {}


def per_term(H, bucket, side: str):
    """The bucket term's per-term plan: its own, or, for a bucket with a
    pair plan, the one ``prepare_tiled_matvec`` builds without the pass."""
    plan = bucket.plan_t if side == "t" else bucket.plan_s
    if plan is None:
        key = (id(bucket), side)
        if key not in _PER_TERM:
            build = (build_tile_plan if isinstance(bucket, ht.DenseBucket)
                     else build_tile_plan_lr_split)
            _PER_TERM[key] = (bucket, build(bucket, side, H.shape[0] + _pad_in_of(H)))
        plan = _PER_TERM[key][1]
    return plan


def stages(H, bucket, side: str):
    """[(plan, rows, cols)] of a bucket term: each launch's plan and the
    true rows and columns of the matrix it streams, per block."""
    plan = per_term(H, bucket, side)
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
    H, _ = operator(dtype)
    seen = pairs = 0
    for bucket, s in terms(dtype):
        if s != side:
            continue
        if bucket.pair is not None:
            _check_pair_items(bucket, bucket.pair, np.asarray(bucket.t_sizes),
                              np.asarray(bucket.s_sizes))
            pairs += 1
        for plan, rows, cols in stages(H, bucket, side):
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
    assert seen >= 2 and pairs >= (2 if side == "s" else 1)


def _check_pair_items(bucket, plan, rows, cols):
    """A pair plan's items: every live block once (a dense block's rows in
    panels of at most ``tile_rows`` that tile them), with its true columns,
    rank and offsets, sorted by t."""
    it = plan.items.numpy().astype(np.int64)
    b = it[:, 0]
    t_off, s_off = bucket.t_off.numpy(), bucket.s_off.numpy()
    np.testing.assert_array_equal(it[:, 3], t_off[b])
    np.testing.assert_array_equal(it[:, 4], s_off[b])
    np.testing.assert_array_equal(it[:, 5], cols[b])
    assert (np.diff(it[:, 3]) >= 0).all()
    covered = np.zeros(len(rows), np.int64)
    np.add.at(covered, b, it[:, 2] - it[:, 1])
    if plan.kind == "dense":
        assert (it[:, 2] - it[:, 1] <= plan.tile_rows).all() and not it[:, 6].any()
        np.testing.assert_array_equal(covered, rows)
    else:
        ranks = np.asarray(bucket.ranks)
        assert not it[:, 1].any() and len(np.unique(b)) == len(b)
        np.testing.assert_array_equal(it[:, 6], ranks[b])
        np.testing.assert_array_equal(covered, np.where(ranks > 0, rows, 0))


def _pair_formula(bucket, plan, k, item):
    """A pair launch's bytes at k columns: a dense block's rows once, a
    low-rank block's U rows once and V's rows in the launch's cluster
    pieces, each run in whole 32-byte sectors."""
    run = lambda n: -(-int(n) * item // 32) * 32
    t, s = np.asarray(bucket.t_sizes), np.asarray(bucket.s_sizes)
    if plan.kind == "dense":
        return sum(int(r) * run(c) for r, c in zip(t, s))
    geom = dict(zip(pm._GEOM, pm._geometry(plan, pm._kc(k))[0]))
    cs, mc = geom["cs"], geom["mc"]
    total = 0
    for r, c, rk in zip(t.tolist(), s.tolist(), np.asarray(bucket.ranks).tolist()):
        if rk and r and c:
            total += r * run(rk) + rk * sum(run(min(mc, c - q * mc)) for q in range(cs)
                                            if c > q * mc)
    return total


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
    live = padded = pair_live = pair_padded = 0
    for bucket, s in terms(dtype):
        if s != side:
            continue
        if bucket.pair is not None:
            plan, k = bucket.pair, 1 if side == "t" else 8
            want = _pair_formula(bucket, plan, k, item)
            assert plan.streamed_bytes(k) == want
            pair_live += want
            pair_padded += sum(a.numel() for a in (plan.data, plan.V) if a is not None) * item
        for plan, rows, cols in stages(H, bucket, side):
            want = _formula(rows, cols, plan.P, plan.out_w, plan.trans, item)
            assert plan.streamed_bytes() == want
            live += want
            padded += plan.data.numel() * item
    assert 0 < live < padded  # the padding is not streamed
    assert 0 < pair_live < pair_padded


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
