"""Split two-stage low-rank plans and the byte cut rule of the port.

(a) ``build_tile_plan_lr_split`` against the JAX package's on the same
bucket: the JAX route (``tiled_bucket_matvec(planA)`` then ``(planB)``, the
Pallas kernel in interpret mode, float32) against the port's plain two-stage
version, and the plain two-stage version against the dense oracle in
float64; (b) the cut rule covers every entry of every block exactly once;
(c) ``matvec`` with split plans against the unplanned product and the JAX
``matvec``, ``prepare_tiled_matvec``'s plan for every bucket, and the npz
round trip of a split plan, also from a file that holds a one-launch
low-rank plan; (d) the pair pass of symmetric and hermitian operators (a
mirror bucket and its mirror in one launch): its plain version against the
two per-term plain terms, ``matvec`` against the per-term plans and the JAX
package's ``matvec``, its edges (panelled blocks, padding, rank 0, a rank
too wide for it), its counters, and the npz round trip of a pair plan, also
from a file that holds per-term plans."""

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
from htool_tpu_torch.hmatrix import output as output_mod
from htool_tpu_torch.hmatrix.hmatrix import DenseBucket, LowRankBucket
from htool_tpu_torch.hmatrix.linalg import matvec, prepare_tiled_matvec
from htool_tpu_torch.ops import cut as cut_mod
from htool_tpu_torch.ops import tiled_matvec as tiled_mod
from htool_tpu_torch.ops.cut import Cut, cut_rule, lr_stage_shapes, panels
from htool_tpu_torch.ops.tiled_matvec import (
    _STAGE_B_CHUNK,
    SplitPlan,
    TilePlan,
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
    """The plain two-stage version against the dense oracle, block by block,
    in double precision (complex128 for the conjugated case): 1e-12."""
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
    split = build_tile_plan_lr_split(bucket, side, L, 512)
    assert isinstance(split, SplitPlan) and split.stage_a.data is (
        bucket.V if side == "t" else bucket.U) and split.stage_b.data is (
        bucket.U if side == "t" else bucket.V)  # the bucket's own factors, no copies
    got = tiled_bucket_matvec_reference(split, torch.as_tensor(x), conj=conj).numpy()
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
        b.plan_t = b.plan_s = b.pair = None


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("op", ["N", "T", "C"])
@pytest.mark.parametrize("name", ["real", "complex"])
def test_matvec_split_plans_match_one_launch_and_jax(pairs, monkeypatch, name, op, k):
    """``matvec`` with split plans attached equals ``matvec`` without plans
    (the unplanned terms) and the JAX package's ``matvec`` (its XLA path):
    1e-12 in double precision."""
    Hj, Ht = pairs[name]
    monkeypatch.setenv("HTOOL_TPU_PALLAS", "0")
    rng = np.random.RandomState(3)
    x = rng.randn(500, k)
    if name == "complex":
        x = x + 1j * rng.randn(500, k)
    yj = np.asarray(hj.matvec(Hj, jnp.asarray(x), op=op))
    ys = {}
    try:
        for planned in (False, True):
            _clear(Ht)
            if planned:
                prepare_tiled_matvec(Ht, tile_rows=128)
            assert all(isinstance(b.plan_t, SplitPlan) == planned
                       and isinstance(b.plan_s, SplitPlan) == planned for b in Ht.lr_buckets)
            ys[planned] = matvec(Ht, torch.as_tensor(x), op=op).numpy()
    finally:
        _clear(Ht)
    scale = np.abs(yj).max()
    np.testing.assert_allclose(ys[True], ys[False], rtol=1e-12, atol=1e-12 * scale)
    np.testing.assert_allclose(ys[True], yj, rtol=1e-12, atol=1e-12 * scale)


def test_prepare_picks_split_by_the_measured_rule(pairs):
    """``prepare_tiled_matvec`` gives every low-rank bucket, whatever its
    size, the split plan over its own U and V, and every dense bucket a
    dense plan; ``build_tile_plan`` refuses a low-rank bucket."""
    _, Ht = pairs["real"]
    try:
        prepare_tiled_matvec(Ht, tile_rows=128)
        assert Ht.lr_buckets and Ht.dense_buckets
        for b in Ht.lr_buckets:
            for side, plan in (("t", b.plan_t), ("s", b.plan_s)):
                assert isinstance(plan, SplitPlan)
                first, second = (b.V, b.U) if side == "t" else (b.U, b.V)
                assert plan.stage_a.data is first and plan.stage_b.data is second
        for b in Ht.dense_buckets:
            assert type(b.plan_t) is type(b.plan_s) is TilePlan and b.plan_t.data is b.data
        with pytest.raises(TypeError, match="build_tile_plan_lr_split"):
            build_tile_plan(Ht.lr_buckets[0], "t", 500 + 512)
    finally:
        _clear(Ht)


def _as_one_launch_file(path: str, H) -> None:
    """Rewrite the file at ``path`` in the key layout of the port before
    every low-rank plan was split: each low-rank bucket's plan of a side is
    one ``*_tplan_<side>`` plan over whole blocks (P = 1, four blocks a
    step), with no ``_split``, ``_a`` or ``_b`` keys."""
    with np.load(path) as z:
        payload = dict(z)
    one_launch = lambda nb, R, C, item, trans, share=1.0: Cut(1, C if trans else R, 4)
    for k, b in enumerate(H.lr_buckets):
        prefix = f"l{k}_tplan_"
        for key in [key for key in payload if key.startswith(prefix)]:
            del payload[key]
        stand = DenseBucket(data=torch.zeros((b.n_blocks, *b.block_shape)), t_off=b.t_off,
                            s_off=b.s_off)  # the same schedule as the one-launch plan's
        for side in ("t", "s"):
            split = getattr(b, f"plan_{side}")
            with mock.patch.object(tiled_mod, "cut_rule", one_launch):
                one = build_tile_plan(stand, side, split.out_len, split.stage_b.T)
            output_mod._pack_plan(payload, f"{prefix}{side}", one)
    np.savez_compressed(path, **payload)


@pytest.mark.parametrize("name, layout", [("real", "split"), ("complex", "split"),
                                          ("real", "one_launch")],
                         ids=["real", "complex", "real-one-launch-file"])
def test_split_plan_save_load_roundtrip(pairs, tmp_path, name, layout):
    """``save_hmatrix``/``load_hmatrix`` round-trip a split plan: both stages'
    schedules over the reloaded bucket's own U and V, and equal products.  A
    file that holds one-launch low-rank plans loads as the same split plans."""
    _, Ht = pairs[name]
    try:
        prepare_tiled_matvec(Ht, tile_rows=128)
        path = str(tmp_path / "h.npz")
        ht.save_hmatrix(Ht, path)
        if layout == "one_launch":
            _as_one_launch_file(path, Ht)
            with np.load(path) as z:
                assert "l0_tplan_t_aux" in z and "l0_tplan_t_split" not in z
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


# --------------------------------------------------------------------------
# (d) the pair pass

from htool_tpu_torch.hmatrix.linalg import _bucket_terms, _pad_in_of
from htool_tpu_torch.ops import pair_matvec as pair_mod
from htool_tpu_torch.ops.pair_matvec import (
    PairPlan,
    build_pair_plan,
    pair_bucket_matvec_reference,
)
from htool_tpu_torch.utils import profiling

SYM_CASES = ["S-float32", "S-float64", "S-complex64", "S-complex128", "H-complex64",
             "H-complex128"]
PAIR_TOL = {"float32": 2e-6, "complex64": 2e-6, "float64": 1e-12, "complex128": 1e-12}


@pytest.fixture(scope="module")
def sym_ops():
    """(JAX H-matrix, the same carried across) of a symmetric real, a
    symmetric complex and a hermitian operator ('L'), n = 500."""
    out = {}
    pts = create_sphere(500)
    tree = hj.ClusterTreeBuilder(max_leaf_size=32, backend="python").build(pts)
    for name, kernel, sym in (("S-real", laplace_kernel_symmetric, "S"),
                              ("S-complex", hj.testing.laplace_kernel_complex_symmetric, "S"),
                              ("H-complex", hj.testing.laplace_kernel_hermitian, "H")):
        gen = hj.KernelGenerator(kernel, pts, pts)
        Hj = hj.build_hmatrix(gen, tree, epsilon=1e-6, eta=10.0, symmetry=sym, UPLO="L")
        out[name] = (Hj, hmatrix_from_numpy(hmatrix_to_numpy(Hj)))
    return out


def _sym_case(sym_ops, case):
    """(JAX H-matrix, the port's in the case's dtype, unplanned, dtype name)."""
    sym, dtype = case.split("-")
    Hj, Ht = sym_ops[f"{sym}-{'complex' if 'complex' in dtype else 'real'}"]
    dt = getattr(torch, dtype)
    H = dataclasses.replace(
        Ht,
        dense_buckets=[dataclasses.replace(b, data=b.data.to(dt), plan_t=None, plan_s=None,
                                           pair=None)
                       for b in Ht.dense_buckets],
        lr_buckets=[dataclasses.replace(b, U=b.U.to(dt), V=b.V.to(dt), plan_t=None, plan_s=None,
                                        pair=None)
                    for b in Ht.lr_buckets])
    return Hj, H, dtype


def _x_of(n, k, complex_, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, k)
    return x + 1j * rng.randn(n, k) if complex_ else x


def _per_term(H):
    """Per-term plans on every bucket (the layout before the pair pass)."""
    pad = _pad_in_of(H)
    for b in H.dense_buckets + H.lr_buckets:
        b.pair = None
        dense = isinstance(b, DenseBucket)
        if dense or b.rank_padded > 0:
            build = build_tile_plan if dense else build_tile_plan_lr_split
            b.plan_t = build(b, "t", H.shape[0] + pad)
            b.plan_s = build(b, "s", H.shape[1] + pad)
    return H


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("case", SYM_CASES)
def test_pair_plan_matches_its_two_terms(sym_ops, case, k):
    """Bucket by bucket, the pair plan's plain version equals the stored and
    the mirror term's plain versions (per-term plans), for the conjugations
    of every op."""
    _, H, dtype = _sym_case(sym_ops, case)
    out_len = H.shape[0] + _pad_in_of(H)
    x = torch.as_tensor(_x_of(out_len, k, "complex" in dtype, 5)).to(getattr(torch, dtype))
    seen = 0
    for b in H.dense_buckets + H.lr_buckets:
        if not b.mirror:
            continue
        pair = build_pair_plan(b, out_len)
        assert isinstance(pair, PairPlan)
        dense = isinstance(b, DenseBucket)
        build = build_tile_plan if dense else build_tile_plan_lr_split
        per_t, per_s = build(b, "t", out_len), build(b, "s", out_len)
        for op in ("N", "T", "C"):
            cj = {out: x.is_complex() and mode in ("C", "conj")
                  for _, out, mode, _ in _bucket_terms(b, op, H.symmetry)}
            got = pair_bucket_matvec_reference(pair, x, None, cj["t"], cj["s"])
            want = tiled_bucket_matvec_reference(per_t, x, conj=cj["t"])
            tiled_bucket_matvec_reference(per_s, x, want, conj=cj["s"])
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= PAIR_TOL[dtype] * scale, (op, type(b))
        seen += 1
    assert seen >= 2


@pytest.mark.parametrize("op", ["N", "T", "C"])
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("case", SYM_CASES)
def test_matvec_pair_pass_matches_per_term_and_jax(sym_ops, monkeypatch, case, k, op):
    """``matvec`` with pair plans (every mirror bucket in one launch) equals
    ``matvec`` with per-term plans and the JAX package's ``matvec``; each
    product counts its mirror buckets as fused, and none as split."""
    Hj, H, dtype = _sym_case(sym_ops, case)
    monkeypatch.setenv("HTOOL_TPU_PALLAS", "0")
    x = _x_of(500, k, "complex" in dtype, 3)
    yj = np.asarray(hj.matvec(Hj, jnp.asarray(x), op=op))
    xt = torch.as_tensor(x).to(getattr(torch, dtype))
    prepare_tiled_matvec(H)
    n_mirror = sum(b.mirror for b in H.dense_buckets + H.lr_buckets)
    assert n_mirror >= 2 and all(isinstance(b.pair, PairPlan) and b.plan_t is b.plan_s is None
                                 for b in H.dense_buckets + H.lr_buckets if b.mirror)
    before = profiling.counters()
    y_pair = matvec(H, xt, op=op)
    after = profiling.counters()
    assert after.get("product_pairs_fused", 0) - before.get("product_pairs_fused", 0) == n_mirror
    assert after.get("product_pairs_split", 0) == before.get("product_pairs_split", 0)
    y_terms = matvec(_per_term(H), xt, op=op)
    assert profiling.counters().get("product_pairs_split", 0) - after.get(
        "product_pairs_split", 0) == n_mirror
    scale = np.abs(yj).max()
    np.testing.assert_allclose(y_pair.numpy(), y_terms.numpy(), rtol=0,
                               atol=PAIR_TOL[dtype] * scale)
    tol = 1e-12 if dtype in ("float64", "complex128") else 2e-6
    np.testing.assert_allclose(y_pair.numpy(), yj, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("edge", ["panels", "nan_padding", "rank0", "wide_rank"])
def test_pair_pass_edges(sym_ops, monkeypatch, edge):
    """Dense blocks cut into panels; every padded entry NaN (nothing past
    the live extents is read); blocks of rank 0 inside a bucket and a bucket
    of rank 0; a bucket whose rank is too wide for the pass keeps its
    per-term plans and counts as split."""
    from htool_tpu_torch.testing import fill_padding

    _, H, dtype = _sym_case(sym_ops, "S-float64")
    x = torch.as_tensor(_x_of(500, 3, False, 9))
    want = matvec(_per_term(H), x)
    for b in H.dense_buckets + H.lr_buckets:
        b.plan_t = b.plan_s = b.pair = None
    if edge == "panels":
        monkeypatch.setattr(pair_mod, "_TILE_BYTES", 4096)  # about 16 rows of 32 doubles
        prepare_tiled_matvec(H)
        dense = [b for b in H.dense_buckets if b.mirror]
        assert dense
        for b in dense:
            items = b.pair.items.numpy()
            assert 4 <= b.pair.tile_rows < int(np.max(b.t_sizes))
            assert (items[:, 1] > 0).any() and (items[:, 2] - items[:, 1] <= 16).all()
    elif edge == "nan_padding":
        H = prepare_tiled_matvec(fill_padding(H, float("nan")))
        assert all(isinstance(b.pair, PairPlan) for b in H.lr_buckets if b.mirror)
    elif edge == "rank0":
        b = next(b for b in H.lr_buckets if b.mirror)
        b.ranks = np.asarray(b.ranks).copy()
        b.ranks[: len(b.ranks) // 2] = 0  # half the blocks: no rank, no item
        zero = torch.as_tensor(b.ranks, device=b.U.device) == 0
        b.U = b.U.masked_fill(zero[:, None, None], 0.0)
        want = matvec(_per_term(H), x)
        empty = LowRankBucket(U=b.U[:, :, :0], V=b.V[:, :0], t_off=b.t_off, s_off=b.s_off,
                              t_sizes=b.t_sizes, s_sizes=b.s_sizes,
                              ranks=np.zeros_like(b.ranks), mirror=True)
        H.lr_buckets.append(empty)
        prepare_tiled_matvec(H)
        assert b.pair.n_items == int((np.asarray(b.ranks) > 0).sum())
        assert empty.plan_t is None and empty.plan_s is None and empty.pair is None
    else:
        b = next(b for b in H.lr_buckets if b.mirror)
        monkeypatch.setattr(pair_mod, "_SMEM_MAX", 8 * 1024)
        monkeypatch.setattr(pair_mod, "_SMEM_TWO", 8 * 1024)
        prepare_tiled_matvec(H)
        assert b.pair is None
        assert isinstance(b.plan_t, SplitPlan) and isinstance(b.plan_s, SplitPlan)
    before = profiling.counters()
    got = matvec(H, x)
    split = profiling.counters().get("product_pairs_split", 0) - before.get(
        "product_pairs_split", 0)
    assert split == (sum(b.mirror for b in H.lr_buckets + H.dense_buckets
                         if b.pair is None) if edge == "wide_rank" else 0)
    assert split > 0 or edge != "wide_rank"
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("layout", ["pair", "per_term_file"])
def test_pair_plan_save_load_roundtrip(sym_ops, tmp_path, layout):
    """``save_hmatrix``/``load_hmatrix`` keep a pair plan (its items over the
    reloaded bucket's own tensors, one object as both sides' plan); a file
    that holds per-term plans of mirror buckets loads as the same pair
    plans."""
    _, H, _ = _sym_case(sym_ops, "S-complex128")
    (_per_term if layout == "per_term_file" else prepare_tiled_matvec)(H)
    path = str(tmp_path / "h.npz")
    ht.save_hmatrix(H, path)
    with np.load(path) as z:
        assert ("d1_tplan_pair_aux" in z) == (layout == "pair") or not H.dense_buckets[1].mirror
    back = ht.load_hmatrix(path, device="cpu")
    prepare_tiled_matvec(H)
    for ba, bb in zip(H.dense_buckets + H.lr_buckets, back.dense_buckets + back.lr_buckets):
        if not ba.mirror:
            continue
        pa, pb = ba.pair, bb.pair
        assert isinstance(pb, PairPlan) and bb.plan_t is bb.plan_s is None
        assert pb.data is (bb.data if isinstance(bb, DenseBucket) else bb.U)
        for f in dataclasses.fields(pa):
            va, vb = getattr(pa, f.name), getattr(pb, f.name)
            if f.name not in ("data", "V"):
                assert (torch.equal(va, vb) if isinstance(va, torch.Tensor) else va == vb), f.name
    x = torch.as_tensor(_x_of(500, 2, True, 4))
    for op in ("N", "T", "C"):
        assert torch.equal(matvec(back, x, op=op), matvec(H, x, op=op))


@pytest.mark.parametrize("k", [1, 8])
def test_pair_plan_of_a_wider_dtype(k):
    """A float32 'S' operator whose rank-99 bucket of 1001 x 777 blocks
    takes the pair pass in float32 (a cluster of 4 CTAs at KC = 8), but
    whose float64 factors fit no layout: a float64 x gives no pair plan for
    the wider dtype, the bucket's two terms run unplanned and count as
    split, and the product is the dense one's."""
    g = torch.Generator().manual_seed(11)
    U, V = torch.randn(2, 1001, 99, generator=g), torch.randn(2, 99, 777, generator=g)
    t_off, s_off = [1000, 1100], [0, 100]
    b = LowRankBucket(U=U, V=V, t_off=torch.tensor(t_off), s_off=torch.tensor(s_off),
                      t_sizes=np.full(2, 1001), s_sizes=np.full(2, 777),
                      ranks=np.full(2, 99), mirror=True)
    n = 2200
    H = ht.HMatrix(shape=(n, n), dense_buckets=[], lr_buckets=[b], perm_t=torch.arange(n),
                   perm_s=torch.arange(n), symmetry="S", UPLO="L")
    prepare_tiled_matvec(H)
    assert isinstance(b.pair, PairPlan) and b.pair.astype(torch.float64) is None
    A = torch.zeros(n, n, dtype=torch.float64)
    for i, (t, s) in enumerate(zip(t_off, s_off)):
        A[t:t + 1001, s:s + 777] += U[i].double() @ V[i].double()
    x = torch.as_tensor(np.random.RandomState(2).randn(n, k))
    before = profiling.counters()
    got = matvec(H, x)
    after = profiling.counters()
    assert after.get("product_pairs_split", 0) - before.get("product_pairs_split", 0) == 1
    assert after.get("product_pairs_fused", 0) == before.get("product_pairs_fused", 0)
    want = (A + A.T) @ x
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * float(want.abs().max()))
    got32 = matvec(H, x.float())  # the pair pass, in float32
    assert profiling.counters().get("product_pairs_fused", 0) - after.get(
        "product_pairs_fused", 0) == 1
    np.testing.assert_allclose(got32.numpy(), want.numpy(), rtol=0,
                               atol=2e-5 * float(want.abs().max()))
