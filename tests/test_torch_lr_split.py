"""Split two-stage low-rank plans and the byte cut rule of the port.

(a) ``build_tile_plan_lr_split`` against the JAX package's on the same
bucket: the JAX route (``tiled_bucket_matvec(planA)`` then ``(planB)``, the
Pallas kernel in interpret mode, float32) against the port's plain two-stage
version, and the plain two-stage version against the plain one-launch
version in float64; (b) the cut rule covers every entry of every block
exactly once; (c) ``matvec`` with split plans against one-launch plans and
the JAX ``matvec``, and the npz round trip of a split plan."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

from unittest import mock

import jax
import jax.numpy as jnp
from hypothesis import given, settings
from hypothesis import strategies as st

import htool_tpu as hj
from htool_tpu.hmatrix.hmatrix import LowRankBucket as JaxLowRankBucket
from htool_tpu.ops.tiled_matvec import build_tile_plan_lr_split as jax_build_split
from htool_tpu.ops.tiled_matvec import tiled_bucket_matvec as jax_tiled_bucket_matvec
from htool_tpu.testing import create_sphere, laplace_kernel_symmetric
import htool_tpu_torch as ht
from htool_tpu_torch.convert import hmatrix_from_numpy
from htool_tpu_torch.hmatrix.hmatrix import LowRankBucket
from htool_tpu_torch.hmatrix.linalg import matvec, prepare_tiled_matvec
from htool_tpu_torch.ops import cut as cut_mod
from htool_tpu_torch.ops.cut import cut_rule, lr_split_wanted, lr_stage_shapes, panels
from htool_tpu_torch.ops.tiled_matvec import (
    _STAGE_B_CHUNK,
    SplitPlan,
    _chunk_stand_width,
    build_tile_plan,
    build_tile_plan_lr_split,
    tiled_bucket_matvec,
    tiled_bucket_matvec_reference,
)
from torch_parity import hmatrix_to_numpy

# widths below the 2048 chunk of stage B, above it and no multiple of it (the
# case the reference pads), and above it as a multiple
WIDTHS = {"below": 300, "above_ragged": _STAGE_B_CHUNK + 260, "above_multiple": 2 * _STAGE_B_CHUNK}


def _bucket_arrays(W, dtype, nb=3, r=5, seed=0):
    rng = np.random.RandomState(seed)
    L = W + 700
    return dict(
        U=(rng.randn(nb, W, r) / np.sqrt(r)).astype(dtype),
        V=rng.randn(nb, r, W).astype(dtype),
        t_off=rng.randint(0, L - W, nb).astype(np.int64),
        s_off=rng.randint(0, L - W, nb).astype(np.int64),
    ), L


def _torch_bucket(a):
    return LowRankBucket(U=torch.as_tensor(a["U"]), V=torch.as_tensor(a["V"]),
                         t_off=torch.as_tensor(a["t_off"]), s_off=torch.as_tensor(a["s_off"]))


@pytest.mark.parametrize("side", ["t", "s"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_split_plan_matches_jax_split_plan_interpret(monkeypatch, width, side):
    """Same bucket through the JAX package's split plan (Pallas kernel in
    interpret mode, float32) and the port's plain two-stage version: 1e-5,
    float32 sums in another order."""
    a, L = _bucket_arrays(WIDTHS[width], np.float32)
    x = np.random.RandomState(1).randn(L + 16, 2).astype(np.float32)
    bj = JaxLowRankBucket(U=jnp.asarray(a["U"]), V=jnp.asarray(a["V"]),
                          t_off=a["t_off"].astype(np.int32), s_off=a["s_off"].astype(np.int32))
    monkeypatch.setenv("HTOOL_TPU_PALLAS", "interpret")
    jax.clear_caches()
    plan_a, plan_b = jax_build_split(bj, side, L, 512)
    t_mid = jax_tiled_bucket_matvec(plan_a, jnp.asarray(x), jnp.float32)
    yj = np.asarray(jax_tiled_bucket_matvec(plan_b, t_mid, jnp.float32))
    jax.clear_caches()
    split = build_tile_plan_lr_split(_torch_bucket(a), side, L, 512)
    yt = tiled_bucket_matvec_reference(split, torch.as_tensor(x)).numpy()
    assert yt.shape == yj.shape == (L, 2)
    assert np.linalg.norm(yt - yj) / np.linalg.norm(yj) <= 1e-5
    # on CPU tensors the wrapper is the plain version
    np.testing.assert_array_equal(tiled_bucket_matvec(split, torch.as_tensor(x)).numpy(), yt)


@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("side", ["t", "s"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_split_plan_matches_one_launch_plan_f64(width, side, conj):
    """The plain two-stage version against the plain one-launch version in
    double precision (complex128 for the conjugated case): 1e-12."""
    dtype = np.complex128 if conj else np.float64
    a, L = _bucket_arrays(WIDTHS[width], np.float64)
    if conj:
        b, _ = _bucket_arrays(WIDTHS[width], np.float64, seed=5)
        a["U"], a["V"] = a["U"] + 1j * b["U"], a["V"] + 1j * b["V"]
    rng = np.random.RandomState(2)
    x = rng.randn(L, 3).astype(dtype)
    if conj:
        x = x + 1j * rng.randn(L, 3)
    bucket = _torch_bucket(a)
    one = build_tile_plan(bucket, side, L, 512)
    split = build_tile_plan_lr_split(bucket, side, L, 512)
    assert isinstance(split, SplitPlan) and split.stage_a.data is (
        bucket.V if side == "t" else bucket.U) and split.stage_b.data is (
        bucket.U if side == "t" else bucket.V)  # the bucket's own factors, no copies
    want = tiled_bucket_matvec_reference(one, torch.as_tensor(x), conj=conj).numpy()
    got = tiled_bucket_matvec_reference(split, torch.as_tensor(x), conj=conj).numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-12
    # dense oracle
    y = np.zeros((L, 3), dtype)
    for i in range(a["U"].shape[0]):
        B = a["U"][i] @ a["V"][i]
        B = B.conj() if conj else B
        o, q = (a["t_off"][i], a["s_off"][i]) if side == "t" else (a["s_off"][i], a["t_off"][i])
        W = WIDTHS[width]
        y[o : o + W] += (B if side == "t" else B.T) @ x[q : q + W]
    assert np.linalg.norm(got - y) / np.linalg.norm(y) <= 1e-12


@pytest.mark.parametrize("W", [1, 17, _STAGE_B_CHUNK - 1, _STAGE_B_CHUNK, _STAGE_B_CHUNK + 1,
                               3 * _STAGE_B_CHUNK + 5, 6272])
def test_stage_b_chunks_are_clipped_not_padded(W):
    """Stage B's output chunks tile [0, W) exactly, each at most 2048 wide:
    the tail chunk is clipped, where the reference pads W to whole chunks."""
    chunks = _chunk_stand_width(W)
    assert chunks[0][0] == 0 and chunks[-1][1] == W
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(0 < hi - lo <= _STAGE_B_CHUNK for lo, hi in chunks)
    assert len(chunks) == -(-W // _STAGE_B_CHUNK)


def _covered(nb, R, C, cut, trans):
    """How often each entry of nb matrices [R, C] is streamed by the CTAs of
    one launch cut by ``cut``: slot v = b·P + p takes panel p of block b."""
    P, width, G = cut
    ext = C if trans else R
    count = np.zeros((nb, R, C), np.int64)
    spans = panels(ext, P, width)
    n_slots = nb * P
    for cta in range(-(-n_slots // G)):
        for v in range(cta * G, min(n_slots, (cta + 1) * G)):
            b, p = divmod(v, P)
            lo, hi = spans[p]
            if trans:
                count[b, :, lo:hi] += 1
            else:
                count[b, lo:hi, :] += 1
    return count


@settings(max_examples=120, deadline=None, derandomize=True, database=None)
@given(nb=st.integers(1, 5), bm=st.integers(1, 700), bn=st.integers(1, 700),
       r=st.integers(1, 130), itemsize=st.sampled_from([4, 8, 16]), trans=st.booleans(),
       target=st.sampled_from([None, 1 << 10, 1 << 14, 1 << 18]))
def test_cut_rule_covers_every_entry_once(nb, bm, bn, r, itemsize, trans, target):
    """Dense blocks and both stages of a low-rank block, stored and
    transposed: the panels of the cut cover every entry exactly once, a slab
    of a transposed matrix is at most 256 columns wide and starts on a
    16-byte boundary, and G panels go to a CTA."""
    shapes = [(bm, bn), *lr_stage_shapes(bm, bn, r, trans)]
    # a byte target of the rule's own, or a finer one set for the test
    consts = dict(_TARGET_BYTES=cut_mod._TARGET_BYTES if target is None else target,
                  _MIN_BYTES=cut_mod._MIN_BYTES if target is None else target)
    for R, C in shapes:
        with mock.patch.multiple(cut_mod, **consts):
            cut = cut_rule(nb, R, C, itemsize, trans)
        ext = C if trans else R
        assert cut.P >= 1 and cut.G >= 1 and 1 <= cut.cut <= ext
        assert cut.P == -(-ext // cut.cut)
        if trans:
            assert cut.cut <= 256
            assert cut.P == 1 or (cut.cut * itemsize) % 16 == 0
        assert (_covered(nb, R, C, cut, trans) == 1).all()


def test_cut_rule_fills_the_card_with_few_large_blocks():
    """The 10 blocks of a 6272-wide rank-8 bucket spread over 80 CTAs and
    more in every stage (one rank row each at the least), and one 25.7 MB
    block (3136², rank 512, complex64) over 64 CTAs and more (slabs of 64 bytes a
    row at the least)."""
    for nb, bm, bn, r, item, least in ((10, 6272, 6272, 8, 4, 80),
                                       (1, 3136, 3136, 512, 8, 64)):
        for trans in (False, True):
            for R, C in lr_stage_shapes(bm, bn, r, trans):
                P, _, G = cut_rule(nb, R, C, item, trans)
                if trans and C == r == 8:  # U [6272, 8] transposed: 32-byte rows, one slab
                    assert (P, -(-nb * P // G)) == (1, nb)
                else:
                    assert -(-nb * P // G) >= least, (nb, R, C, trans, P, G)


@pytest.fixture(scope="module")
def pairs():
    """(JAX H-matrix, the same carried across) real and complex, n = 500."""
    out = {}
    pts = create_sphere(500)
    tree = hj.ClusterTreeBuilder(max_leaf_size=32, backend="python").build(pts)
    for name, kernel in (("real", laplace_kernel_symmetric),
                         ("complex", hj.testing.laplace_kernel_complex_symmetric)):
        gen = hj.KernelGenerator(kernel, pts, pts)
        Hj = hj.build_hmatrix(gen, tree, epsilon=1e-6, eta=10.0)
        out[name] = (Hj, hmatrix_from_numpy(hmatrix_to_numpy(Hj)))
    return out


def _clear(H):
    for b in H.dense_buckets + H.lr_buckets:
        b.plan_t = b.plan_s = None


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("op", ["N", "T", "C"])
@pytest.mark.parametrize("name", ["real", "complex"])
def test_matvec_split_plans_match_one_launch_and_jax(pairs, monkeypatch, name, op, k):
    """``matvec`` with split plans attached equals ``matvec`` with
    one-launch plans and the JAX package's ``matvec`` (its XLA path): 1e-12
    in double precision."""
    Hj, Ht = pairs[name]
    monkeypatch.setenv("HTOOL_TPU_PALLAS", "0")
    rng = np.random.RandomState(3)
    x = rng.randn(500, k)
    if name == "complex":
        x = x + 1j * rng.randn(500, k)
    yj = np.asarray(hj.matvec(Hj, jnp.asarray(x), op=op))
    ys = {}
    try:
        for split in (False, True):
            _clear(Ht)
            prepare_tiled_matvec(Ht, tile_rows=128, lr_split=split)
            assert all(isinstance(b.plan_t, SplitPlan) == split
                       and isinstance(b.plan_s, SplitPlan) == split for b in Ht.lr_buckets)
            ys[split] = matvec(Ht, torch.as_tensor(x), op=op).numpy()
    finally:
        _clear(Ht)
    scale = np.abs(yj).max()
    np.testing.assert_allclose(ys[True], ys[False], rtol=1e-12, atol=1e-12 * scale)
    np.testing.assert_allclose(ys[True], yj, rtol=1e-12, atol=1e-12 * scale)


def test_prepare_picks_split_by_the_measured_rule(pairs):
    """Without ``lr_split`` each low-rank bucket gets the plan
    ``lr_split_wanted`` names for its number of blocks, shape, rank and
    scalar size."""
    _, Ht = pairs["real"]
    try:
        prepare_tiled_matvec(Ht, tile_rows=128)
        kinds = set()
        for b in Ht.lr_buckets:
            want = lr_split_wanted(b.n_blocks, *b.block_shape, b.rank_padded,
                                   b.U.element_size())
            assert isinstance(b.plan_t, SplitPlan) == isinstance(b.plan_s, SplitPlan) == want
            kinds.add(want)
        assert kinds  # the H-matrix has low-rank buckets
    finally:
        _clear(Ht)
    # long terms run in two stages: 4 MB a bucket and up, or 128 KB a block
    assert lr_split_wanted(367, 1568, 1568, 16, 4) and lr_split_wanted(2637, 224, 224, 16, 4)
    assert lr_split_wanted(1, 3136, 3136, 512, 8) and lr_split_wanted(10, 6272, 6272, 8, 4)
    # short ones in one launch, whatever the bytes of a block below 128 KB
    assert not lr_split_wanted(100, 32, 32, 8, 4) and not lr_split_wanted(30, 416, 416, 32, 4)
    # a caller that knows k = 1 splits only blocks of 1 MB and more
    assert not lr_split_wanted(367, 1568, 1568, 16, 4, k=1)
    assert lr_split_wanted(367, 1568, 1568, 16, 4, k=8)
    assert lr_split_wanted(8, 3136, 3136, 512, 8, k=1)


@pytest.mark.parametrize("name", ["real", "complex"])
def test_split_plan_save_load_roundtrip(pairs, tmp_path, name):
    """``save_hmatrix``/``load_hmatrix`` round-trip a split plan: both stages'
    schedules over the reloaded bucket's own U and V, and equal products."""
    _, Ht = pairs[name]
    try:
        prepare_tiled_matvec(Ht, tile_rows=128, lr_split=True)
        path = str(tmp_path / "h.npz")
        ht.save_hmatrix(Ht, path)
        back = ht.load_hmatrix(path, device="cpu")
        assert back.lr_buckets
        for ba, bb in zip(Ht.lr_buckets, back.lr_buckets):
            for side in ("t", "s"):
                pa, pb = getattr(ba, f"plan_{side}"), getattr(bb, f"plan_{side}")
                assert isinstance(pb, SplitPlan) and pb.r_pad == pa.r_pad
                first, second = (bb.V, bb.U) if side == "t" else (bb.U, bb.V)
                assert pb.stage_a.data is first and pb.stage_b.data is second
                for qa, qb in zip(pa, pb):
                    for f in dataclasses.fields(qa):
                        va, vb = getattr(qa, f.name), getattr(qb, f.name)
                        assert (torch.equal(va, vb) if isinstance(va, torch.Tensor)
                                else va == vb), f.name
        x = np.random.RandomState(4).randn(500, 2)
        x = torch.as_tensor(x + (1j * x[::-1] if name == "complex" else 0))
        for op in ("N", "T", "C"):
            assert torch.equal(matvec(back, x, op=op), matvec(Ht, x, op=op))
    finally:
        _clear(Ht)
