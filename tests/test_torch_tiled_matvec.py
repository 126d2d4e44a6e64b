"""Tiled bucket matvec of the port against the JAX package: the host plan,
the plain version of the Hopper kernel against the Pallas kernel (interpret
mode; a low-rank bucket's split plan against the reference's one-launch
plan), and H-matrix products on an H-matrix carried across."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import htool_tpu as hj
from htool_tpu.ops.tiled_matvec import build_tile_plan as jax_build_tile_plan
from htool_tpu.ops.tiled_matvec import tiled_bucket_matvec as jax_tiled_bucket_matvec
from htool_tpu.testing import create_sphere, laplace_kernel_symmetric
from htool_tpu_torch.convert import hmatrix_from_numpy
from htool_tpu_torch.hmatrix.hmatrix import DenseBucket, LowRankBucket
from htool_tpu_torch.hmatrix.linalg import _pad_in_of, matvec, matvec_user, prepare_tiled_matvec
from htool_tpu_torch.ops.pair_matvec import pair_bucket_matvec
from htool_tpu_torch.ops.tiled_matvec import (
    SplitPlan,
    build_tile_plan,
    build_tile_plan_lr_split,
    tiled_bucket_matvec,
    tiled_bucket_matvec_reference,
)
from torch_parity import hmatrix_to_numpy

N = 700


def _jax_hmatrix(dtype, symmetry="N", UPLO="N"):
    pts = create_sphere(N).astype(dtype)
    tree = hj.ClusterTreeBuilder(max_leaf_size=32, backend="python").build(pts)
    gen = hj.KernelGenerator(laplace_kernel_symmetric, pts, pts)
    return hj.build_hmatrix(gen, tree, epsilon=1e-5, eta=10.0, symmetry=symmetry, UPLO=UPLO)


@pytest.fixture(scope="module")
def pair64():
    Hj = _jax_hmatrix(np.float64)
    return Hj, hmatrix_from_numpy(hmatrix_to_numpy(Hj))


@pytest.fixture(scope="module")
def pair32():
    Hj = _jax_hmatrix(np.float32)
    return Hj, hmatrix_from_numpy(hmatrix_to_numpy(Hj))


@pytest.fixture(scope="module")
def pair64_sym():
    Hj = _jax_hmatrix(np.float64, "S", "L")
    return Hj, hmatrix_from_numpy(hmatrix_to_numpy(Hj))


def _buckets(H):
    return H.dense_buckets + H.lr_buckets


@pytest.mark.parametrize("side", ["t", "s"])
def test_plan_parity(pair64, side):
    """Same dense bucket, same tile_rows: every tile holds the same blocks in
    the same order with the same in_off/out_rel (a low-rank bucket's split
    plan has no one-launch counterpart to compare)."""
    Hj, Ht = pair64
    out_len = N + _pad_in_of(Ht)
    assert Ht.dense_buckets
    for bj, bt in zip(Hj.dense_buckets, Ht.dense_buckets):
        pj = jax_build_tile_plan(bj, side, out_len, 128)
        pt = build_tile_plan(bt, side, out_len, 128)
        assert (pj.kind, pj.T, pj.E, pj.n_tiles, pj.out_len, pj.in_w, pj.out_w, pj.trans) == (
            pt.kind, pt.T, pt.E, pt.n_tiles, pt.out_len, pt.in_w, pt.out_w, pt.trans)
        assert pt.n_tiles > 1
        tile_j = np.repeat(np.asarray(pj.tile_of), pj.G)
        in_j, rel_j = np.asarray(pj.in_off), np.asarray(pj.out_rel)
        blocks_j = np.asarray(pj.data)
        blk = pt.blk.numpy()
        tile_t = np.repeat(pt.tile_of.numpy(), pt.G)
        assert np.all(np.diff(pt.tile_of.numpy()) >= 0)
        first = pt.first_of.numpy()
        assert np.array_equal(first.astype(bool),
                              np.r_[True, np.diff(pt.tile_of.numpy()) > 0])
        blocks_t = bt.data.numpy()
        for t in range(pt.n_tiles):
            slots = np.nonzero((tile_t == t) & (blk >= 0))[0]
            js = np.nonzero(tile_j == t)[0]
            c = slots.size
            assert js.size >= max(c, 1)
            np.testing.assert_array_equal(in_j[js[:c]], pt.in_off.numpy()[slots])
            np.testing.assert_array_equal(rel_j[js[:c]], pt.out_rel.numpy()[slots])
            np.testing.assert_array_equal(blocks_j[js[:c]], blocks_t[blk[slots]])
            assert not blocks_j[js[c:]].any()  # JAX pads tiles with zero blocks
            assert np.all(pt.out_rel.numpy()[slots] < pt.T)
        # padding only at the end of a tile's last step
        assert (blk.reshape(-1, pt.G) >= 0)[:, 0].all()
        # the kernel's row is the folded row of the reference's tile walk
        real = blk >= 0
        np.testing.assert_array_equal(
            pt.out_off.numpy()[real], (tile_t * pt.T + pt.out_rel.numpy())[real])


@pytest.mark.parametrize("kind", ["dense", "lr"])
@pytest.mark.parametrize("side", ["t", "s"])
def test_reference_matches_pallas_interpret(pair32, monkeypatch, kind, side):
    """The plain version of the Hopper kernel against the Pallas kernel run
    in interpret mode (f32, blocks straddling 256-row tiles): a dense bucket's
    plan against the reference's, a low-rank bucket's split plan against the
    reference's one-launch plan."""
    Hj, Ht = pair32
    pick = lambda H: max(H.dense_buckets if kind == "dense" else H.lr_buckets,
                         key=lambda b: b.n_blocks)
    bj, bt = pick(Hj), pick(Ht)
    out_len = N + _pad_in_of(Ht)
    x = np.random.RandomState(4).randn(out_len + 16, 3).astype(np.float32)
    monkeypatch.setenv("HTOOL_TPU_PALLAS", "interpret")
    jax.clear_caches()
    yj = np.asarray(jax_tiled_bucket_matvec(jax_build_tile_plan(bj, side, out_len, 128),
                                            jnp.asarray(x), jnp.float32))
    jax.clear_caches()
    pt = (build_tile_plan if kind == "dense" else build_tile_plan_lr_split)(bt, side, out_len, 128)
    yt = tiled_bucket_matvec_reference(pt, torch.as_tensor(x)).numpy()
    assert yt.shape == yj.shape == (out_len, 3)
    assert np.linalg.norm(yt - yj) / np.linalg.norm(yj) <= 1e-5
    # on CPU tensors the wrapper is the plain version
    np.testing.assert_array_equal(tiled_bucket_matvec(pt, torch.as_tensor(x)).numpy(), yt)


def _kernel_walk(plan, x):
    """The CUDA kernel's traversal in Python: step i walks slots i·G ..
    i·G + G - 1, skips blk < 0, and adds panel blk % P of op(D[blk // P])
    · x window straight into y at row out_off (the fold, done as it goes).
    A split plan walks stage A into t, then stage B from t."""
    if isinstance(plan, SplitPlan):
        return _kernel_walk(plan.stage_b, _kernel_walk(plan.stage_a, x))
    y = torch.zeros((plan.out_len, x.shape[1]), dtype=x.dtype)
    blk = plan.blk.tolist()
    for i in range(plan.n_steps):
        for s in range(i * plan.G, (i + 1) * plan.G):
            if blk[s] < 0:
                continue
            b, p = divmod(blk[s], plan.P)
            xw = x[int(plan.in_off[s]) : int(plan.in_off[s]) + plan.in_w]
            B = plan.data[b]
            op = B.T if plan.trans else B
            r = int(plan.out_off[s])
            rows = op[p * plan.out_w : (p + 1) * plan.out_w]  # the last panel is clipped
            y[r : r + rows.shape[0]] += rows @ xw
    return y


@pytest.mark.parametrize("side", ["t", "s"])
def test_kernel_walk_matches_reference(pair64, side):
    Hj, Ht = pair64
    out_len = N + _pad_in_of(Ht)
    x = torch.as_tensor(np.random.RandomState(5).randn(out_len, 2))
    for b in _buckets(Ht):
        build = build_tile_plan if isinstance(b, DenseBucket) else build_tile_plan_lr_split
        plan = build(b, side, out_len, 128)
        np.testing.assert_allclose(_kernel_walk(plan, x).numpy(),
                                   tiled_bucket_matvec_reference(plan, x).numpy(),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("trans", [False, True])
def test_wide_blocks_extension_beyond_tile(trans):
    """Blocks wider than a tile fold correctly, dense and low rank: cut into
    panels by bytes, which straddle the tiles."""
    rng = np.random.RandomState(6)
    nb, w, r, L = 6, 640, 8, 3000
    offs = torch.as_tensor(rng.randint(0, L - w, nb))
    offs2 = torch.as_tensor(rng.randint(0, L - w, nb))
    U = torch.as_tensor(rng.randn(nb, w, r))
    V = torch.as_tensor(rng.randn(nb, r, w))
    D = U @ V
    x = torch.as_tensor(rng.randn(L + w, 2))
    want = torch.zeros((L + w, 2), dtype=torch.float64)
    for i in range(nb):
        o, q = (offs2[i], offs[i]) if trans else (offs[i], offs2[i])
        B = D[i].T if trans else D[i]
        want[o : o + w] += B @ x[q : q + w]
    side = "s" if trans else "t"
    for plan in (build_tile_plan(DenseBucket(data=D, t_off=offs, s_off=offs2), side, L + w, 128),
                 build_tile_plan_lr_split(LowRankBucket(U=U, V=V, t_off=offs, s_off=offs2), side,
                                          L + w, 128)):
        assert w > (plan.stage_b if isinstance(plan, SplitPlan) else plan).T
        assert isinstance(plan, SplitPlan) or plan.P > 1
        got = tiled_bucket_matvec_reference(plan, x)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-10)
        np.testing.assert_allclose(_kernel_walk(plan, x).numpy(), want.numpy(),
                                   rtol=1e-12, atol=1e-10)


def test_default_tile_rows_from_sm_count():
    """T no longer follows the SM count: the kernel's work per CTA is a
    step of G blocks whatever T is, so T defaults to 256 at every size."""
    from htool_tpu_torch.ops.tiled_matvec import _tile_rows

    assert _tile_rows(100_256, None) == 256
    assert _tile_rows(1_000_000, None) == 256
    assert _tile_rows(700, 128) == 256 and _tile_rows(5000, 1024) == 1024


def test_wrapper_rejects_other_devices(pair64):
    _, Ht = pair64
    plan = build_tile_plan(Ht.dense_buckets[0], "t", N + _pad_in_of(Ht))
    with pytest.raises(ValueError, match="unsupported device"):
        tiled_bucket_matvec(plan, torch.zeros((N + 64, 1), device="meta"))


@pytest.mark.parametrize("op", ["N", "T"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("planned", [False, True])
@pytest.mark.parametrize("sym", ["N", "S"])
def test_matvec_parity_carried_hmatrix(pair64, pair64_sym, op, k, planned, sym):
    """An H-matrix carried across gives the JAX package's products (its XLA
    path) to 1e-12 in f64, through the gather path and the planned path."""
    Hj, Ht = pair64 if sym == "N" else pair64_sym
    if sym == "S":
        assert any(b.mirror for b in _buckets(Ht))
    for b in _buckets(Ht):
        b.plan_t = b.plan_s = b.pair = None
    if planned:
        prepare_tiled_matvec(Ht, tile_rows=128)
    rng = np.random.RandomState(7)
    x = rng.randn(N, k) if k > 1 else rng.randn(N)
    yj = np.asarray(hj.matvec(Hj, jnp.asarray(x), op=op))
    yt = matvec(Ht, torch.as_tensor(x), op=op).numpy()
    assert yt.shape == yj.shape
    np.testing.assert_allclose(yt, yj, rtol=1e-12, atol=1e-12 * np.abs(yj).max())
    yju = np.asarray(hj.matvec_user(Hj, jnp.asarray(x), op=op))
    ytu = matvec_user(Ht, x, op=op).numpy()
    np.testing.assert_allclose(ytu, yju, rtol=1e-12, atol=1e-12 * np.abs(yju).max())
    np.testing.assert_allclose((Ht @ x).numpy(), np.asarray(Hj @ x), rtol=1e-12,
                               atol=1e-12 * np.abs(yju).max())


@pytest.mark.parametrize("sym", ["N", "S"])
def test_matvec_wider_dtype_runs_planned_terms(pair32, pair64_sym, monkeypatch, sym):
    """A float64 input against float32 blocks with plans still sends every
    bucket term through the kernels' wrappers (a mirror bucket's two through
    the pair wrapper, in one call), on blocks cast to float64, and gives the
    float64 gather path's product."""
    from htool_tpu_torch.hmatrix import linalg

    if sym == "N":
        _, Ht = pair32
    else:  # float32 blocks of the symmetric pair: mirror terms too
        H64 = pair64_sym[1]
        Ht = dataclasses.replace(
            H64,
            dense_buckets=[dataclasses.replace(b, data=b.data.float())
                           for b in H64.dense_buckets],
            lr_buckets=[dataclasses.replace(b, U=b.U.float(), V=b.V.float())
                        for b in H64.lr_buckets])
    for b in _buckets(Ht):
        b.plan_t = b.plan_s = b.pair = None
    x = torch.as_tensor(np.random.RandomState(9).randn(N, 2))
    want = matvec(Ht, x)  # no plans: the gather path, in float64
    prepare_tiled_matvec(Ht, tile_rows=128)
    seen = []

    def spy(plan, x_pad, out=None, conj=False):
        seen.append((plan.dtype, x_pad.dtype))
        return tiled_bucket_matvec(plan, x_pad, out=out, conj=conj)

    def spy_pair(plan, x_pad, out=None, conj_t=False, conj_s=False):
        seen.append((plan.dtype, x_pad.dtype))
        return pair_bucket_matvec(plan, x_pad, out=out, conj_t=conj_t, conj_s=conj_s)

    monkeypatch.setattr(linalg, "tiled_bucket_matvec", spy)
    monkeypatch.setattr(linalg, "pair_bucket_matvec", spy_pair)
    try:
        got = matvec(Ht, x)
    finally:
        for b in _buckets(Ht):
            b.plan_t = b.plan_s = b.pair = None
    terms = sum(1 + bool(b.mirror) for b in _buckets(Ht))
    assert (terms > len(_buckets(Ht))) == (sym == "S")
    assert seen == [(torch.float64, torch.float64)] * len(_buckets(Ht))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12 * float(want.abs().max()))


def test_matvec_rejects_stale_plan(pair64):
    """A plan whose output length is not the product's raises instead of
    taking another path."""
    _, Ht = pair64
    prepare_tiled_matvec(Ht, tile_rows=128)
    b = Ht.dense_buckets[0]
    saved = b.plan_t
    b.plan_t = dataclasses.replace(saved, out_len=saved.out_len + 1)
    try:
        with pytest.raises(ValueError, match="prepare_tiled_matvec again"):
            matvec(Ht, torch.zeros(N, dtype=torch.float64))
    finally:
        for bk in _buckets(Ht):
            bk.plan_t = bk.plan_s = bk.pair = None


@pytest.mark.parametrize("sym", ["N", "S"])
def test_copy_diagonal_and_matmat_parity(pair64, pair64_sym, sym):
    from htool_tpu.hmatrix.linalg import copy_diagonal as jax_copy_diagonal
    from htool_tpu_torch.hmatrix.linalg import copy_diagonal, matmat, matmat_user

    Hj, Ht = pair64 if sym == "N" else pair64_sym
    np.testing.assert_allclose(copy_diagonal(Ht).numpy(), np.asarray(jax_copy_diagonal(Hj)),
                               rtol=1e-14, atol=0)
    X = np.random.RandomState(8).randn(N, 4)
    want = np.asarray(hj.matmat(Hj, jnp.asarray(X)))
    np.testing.assert_allclose(matmat(Ht, torch.as_tensor(X)).numpy(), want,
                               rtol=1e-12, atol=1e-12 * np.abs(want).max())
    want_u = np.asarray(hj.matmat_user(Hj, jnp.asarray(X)))
    np.testing.assert_allclose(matmat_user(Ht, X).numpy(), want_u,
                               rtol=1e-12, atol=1e-12 * np.abs(want_u).max())
    np.testing.assert_allclose(Ht.to_dense(), np.asarray(Hj.to_dense()), rtol=1e-13, atol=1e-15)
