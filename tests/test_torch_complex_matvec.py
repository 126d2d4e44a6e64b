"""Complex H-matrix products of the port against the JAX package and the
dense oracle: non-symmetric, complex-symmetric and hermitian storage, ops
N/T/C, with and without tiled plans, complex128 and complex64, a real
H-matrix on a complex x, and the npz round trip of complex plans.

The JAX H-matrix is built once per case and carried across as NumPy arrays
(``hmatrix_from_numpy``), so both packages multiply the same blocks; the
port rebuilds its own plans.  On the CPU the port's wrappers run their
plain versions.  Tolerances: complex128 against the JAX product 1e-12 (the
same blocks, sums in another order) and against the dense matrix 10·ε of
the compression; complex64 1e-4, as the JAX package's own complex64 test.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import htool_tpu as hj
import htool_tpu.hmatrix.linalg as lj
import htool_tpu.hmatrix.output as oj
import htool_tpu_torch as ht
import htool_tpu_torch.hmatrix.output as ot
from htool_tpu.testing import create_sphere
from htool_tpu.testing import kernels as kernels_jax
from htool_tpu_torch.convert import hmatrix_from_numpy
from htool_tpu_torch.hmatrix import linalg as lt
from htool_tpu_torch.ops.bucket_matvec import dense_bucket_matvec, lr_bucket_matvec
from htool_tpu_torch.ops.pair_matvec import PairPlan
from htool_tpu_torch.ops.tiled_matvec import (
    SplitPlan,
    build_tile_plan,
    build_tile_plan_complex,
    build_tile_plan_lr_split,
    tiled_bucket_matvec,
)
from htool_tpu_torch.testing import kernels as kernels_torch
from torch_parity import hmatrix_to_numpy

N, EPS = 600, 1e-5

CASES = {
    "complex-N": ("laplace_kernel_complex", "N", "N"),
    "complex-symmetric-SL": ("laplace_kernel_complex_symmetric", "S", "L"),
    "hermitian-HL": ("laplace_kernel_hermitian", "H", "L"),
    "hermitian-HU": ("laplace_kernel_hermitian", "H", "U"),
}


NS = 500  # source points of the non-symmetric case (its kernel is singular at r = 0)


def _jax_hmatrix(kernel_name, symmetry, UPLO, dtype=None, n=N, leaf=32, eps=EPS):
    pts = create_sphere(n)
    tree = hj.ClusterTreeBuilder(max_leaf_size=leaf, backend="python").build(pts)
    src, src_tree = pts, None
    if kernel_name == "laplace_kernel_complex":  # rectangular, on two spheres
        src = create_sphere(NS, radius=1.5, seed=1)
        src_tree = hj.ClusterTreeBuilder(max_leaf_size=leaf, backend="python").build(src)
    gen = hj.KernelGenerator(getattr(kernels_jax, kernel_name), pts, src, dtype=dtype)
    H = hj.build_hmatrix(gen, tree, src_tree, epsilon=eps, eta=10.0, symmetry=symmetry,
                         UPLO=UPLO)
    return H, np.asarray(gen.to_dense())


@pytest.fixture(scope="module")
def pairs():
    """name -> (JAX H-matrix, the same H-matrix in the port, dense A), complex128."""
    out = {}
    for name, case in CASES.items():
        Hj, A = _jax_hmatrix(*case)
        Ht = hmatrix_from_numpy(hmatrix_to_numpy(Hj))
        assert Ht.dtype == torch.complex128 and (Ht.symmetry, Ht.UPLO) == case[1:]
        out[name] = (Hj, Ht, A)
    return out


def _buckets(H):
    return H.dense_buckets + H.lr_buckets


def _clear_plans(H):
    for b in _buckets(H):
        b.plan_t = b.plan_s = b.pair = None


def _x(n, k, seed, dtype=np.complex128):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, k) + 1j * rng.randn(n, k)).astype(dtype)


def _dense(A, op):
    return {"N": A, "T": A.T, "C": A.conj().T}[op]


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture
def xla_path(monkeypatch):
    monkeypatch.setenv("HTOOL_TPU_PALLAS", "0")
    jax.clear_caches()


@pytest.mark.parametrize("planned", [False, True], ids=["unplanned", "planned"])
@pytest.mark.parametrize("op", ["N", "T", "C"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_complex128_matvec_parity(pairs, xla_path, name, op, planned):
    Hj, Ht, A = pairs[name]
    _clear_plans(Ht)
    if planned:
        lt.prepare_tiled_matvec(Ht, tile_rows=128)
        # a mirror bucket of a symmetric or hermitian operator: one pair plan
        assert all((b.plan_t if b.pair is None else b.pair) is not None
                   and (b.plan_t if b.pair is None else b.pair).dtype == torch.complex128
                   for b in _buckets(Ht))
    try:
        n_in = A.shape[1] if op == "N" else A.shape[0]
        for k in (1, 3):
            x = _x(n_in, k, 7 + k)
            want = np.asarray(lj.matvec_user(Hj, jnp.asarray(x), op=op))
            got = lt.matvec_user(Ht, x, op=op).numpy()
            assert got.shape == want.shape and got.dtype == np.complex128
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
            assert _rel(got, _dense(A, op) @ x) < 10 * EPS
        x1 = _x(n_in, 1, 3)[:, 0]  # a vector stays a vector
        assert _rel(lt.matvec_user(Ht, x1, op=op).numpy(), _dense(A, op) @ x1) < 10 * EPS
    finally:
        _clear_plans(Ht)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("HTOOL_TPU_PALLAS", "interpret")
    jax.clear_caches()
    yield
    monkeypatch.delenv("HTOOL_TPU_PALLAS", raising=False)
    jax.clear_caches()


@pytest.mark.parametrize("name", ["complex-symmetric-N", "hermitian-HL"])
def test_complex64_matvec_parity_with_plane_plans(pallas_interpret, name):
    """complex64: the JAX package runs its re/im plane plans through the
    Pallas kernel (interpret mode); the port runs one plan over the
    interleaved blocks.  Both against each other and the dense matrix."""
    from htool_tpu.ops.tiled_matvec import ComplexPlans

    case = {"complex-symmetric-N": ("laplace_kernel_complex_symmetric", "N", "N"),
            "hermitian-HL": CASES["hermitian-HL"]}[name]
    n = 500
    Hj, A = _jax_hmatrix(*case, dtype=jnp.complex64, n=n, leaf=64)
    Ht = hmatrix_from_numpy(hmatrix_to_numpy(Hj))
    assert Ht.dtype == torch.complex64
    lj.prepare_tiled_matvec(Hj)
    assert all(isinstance(b.plan_t, ComplexPlans) for b in _buckets(Hj))
    lt.prepare_tiled_matvec(Ht)
    x = _x(n, 3, 7, np.complex64)
    for op in ("N", "T", "C"):
        want = np.asarray(lj.matvec_user(Hj, x, op=op))
        got = lt.matvec_user(Ht, x, op=op).numpy()
        assert got.dtype == np.complex64
        assert _rel(got, want) < 1e-4, op
        assert _rel(got, _dense(A, op) @ x) < 1e-4, op
        _clear_plans(Ht)  # and the unplanned wrappers on the same blocks
        assert _rel(lt.matvec_user(Ht, x, op=op).numpy(), want) < 1e-4, op
        lt.prepare_tiled_matvec(Ht)


def test_port_assembles_complex_like_jax():
    """The port's own complex assembly: same buckets and ranks as the JAX
    package's."""
    pts = create_sphere(N)
    tree = ht.ClusterTreeBuilder(max_leaf_size=32, backend="python").build(pts)
    kw = dict(epsilon=EPS, eta=10.0)
    Hc = ht.build_hmatrix(ht.KernelGenerator(kernels_torch.laplace_kernel_complex_symmetric,
                                             pts, pts), tree, **kw)
    Hj, A = _jax_hmatrix("laplace_kernel_complex_symmetric", "N", "N")

    def keys(H):
        return (sorted((b.block_shape, b.n_blocks) for b in H.dense_buckets),
                sorted((b.block_shape, b.n_blocks, int(b.U.shape[2]), int(np.sum(b.ranks)))
                       for b in H.lr_buckets))

    assert keys(Hc) == keys(Hj)
    assert Hc.info["n_false_positive"] == Hj.info["n_false_positive"]
    assert Hc.dtype == torch.complex128
    assert _rel(Hc.to_dense(), A) < EPS
    np.testing.assert_allclose(Hc.to_dense(), np.asarray(Hj.to_dense()), rtol=1e-9,
                               atol=1e-12 * np.abs(A).max())


@pytest.mark.parametrize("planned", [False, True], ids=["unplanned", "planned"])
@pytest.mark.parametrize("width", ["f64-c128", "f32-c64", "f32-c128"])
def test_real_hmatrix_on_complex_x(xla_path, monkeypatch, width, planned):
    """Real blocks against a complex x run the REAL wrappers on x viewed as
    2k real columns, in the product's width; result as the JAX package's."""
    hdt, xdt = {"f64-c128": (None, np.complex128), "f32-c64": (jnp.float32, np.complex64),
                "f32-c128": (jnp.float32, np.complex128)}[width]
    Hj, A = _jax_hmatrix("laplace_kernel_symmetric", "S", "L", dtype=hdt)
    Ht = hmatrix_from_numpy(hmatrix_to_numpy(Hj))
    if planned:
        lt.prepare_tiled_matvec(Ht, tile_rows=128)
    seen = []
    for name in ("tiled_bucket_matvec", "pair_bucket_matvec", "dense_bucket_matvec",
                 "lr_bucket_matvec"):
        real = getattr(lt, name)

        def spy(*a, _real=real, _name=name, **kw):
            x_pad = a[1] if _name in ("tiled_bucket_matvec", "pair_bucket_matvec") else a[-3]
            conj = kw.get("conj_t", False) or kw.get("conj_s", False) if "pair" in _name \
                else kw.get("conj")
            seen.append((_name, x_pad.dtype, x_pad.shape[1], conj))
            return _real(*a, **kw)

        monkeypatch.setattr(lt, name, spy)
    k = 3
    x = _x(N, k, 5, xdt)
    tol = 1e-12 if width == "f64-c128" else 1e-4
    real_dtype = torch.float64 if xdt == np.complex128 else torch.float32
    # planned: a mirror bucket's two terms are one call of the pair wrapper
    terms = sum(1 + bool(b.mirror and not planned) for b in _buckets(Ht))
    for op in ("N", "T", "C"):
        seen.clear()
        got = lt.matvec_user(Ht, x, op=op).numpy()
        assert got.dtype == xdt
        assert len(seen) == terms
        assert {s[1:] for s in seen} == {(real_dtype, 2 * k, False)}
        assert ({s[0] for s in seen} == {"tiled_bucket_matvec", "pair_bucket_matvec"}) == planned
        want = np.asarray(lj.matvec_user(Hj, jnp.asarray(x), op=op))
        assert _rel(got, want) < tol
        assert _rel(got, _dense(A, op) @ x) < max(10 * EPS, tol)


# ---------------------------------------------------------------------------
# the wrappers' conj on random complex buckets, against explicit loops


def _random_bucket(kind, rng, nb=7, bm=24, bn=40, r=5, L=300):
    c = lambda *s: torch.as_tensor(rng.randn(*s) + 1j * rng.randn(*s))
    offs = dict(t_off=torch.as_tensor(rng.randint(0, L - bm, nb)),
                s_off=torch.as_tensor(rng.randint(0, L - bn, nb)))
    if kind == "dense":
        return ht.DenseBucket(data=c(nb, bm, bn), **offs)
    return ht.LowRankBucket(U=c(nb, bm, r), V=c(nb, r, bn), **offs)


def _loop_oracle(bucket, x, trans, conj, L):
    y = np.zeros((L, x.shape[1]), np.complex128)
    for i in range(bucket.n_blocks):
        B = (bucket.data[i] if isinstance(bucket, ht.DenseBucket)
             else bucket.U[i] @ bucket.V[i]).numpy()
        B = B.conj() if conj else B
        B = B.T if trans else B
        t, s = int(bucket.t_off[i]), int(bucket.s_off[i])
        i0, o0 = (t, s) if trans else (s, t)
        y[o0 : o0 + B.shape[0]] += B @ x[i0 : i0 + B.shape[1]]
    return y


@pytest.mark.parametrize("conj", [False, True], ids=["plain", "conj"])
@pytest.mark.parametrize("trans", [False, True], ids=["N", "T"])
@pytest.mark.parametrize("kind", ["dense", "lr"])
def test_wrappers_apply_all_four_modes(kind, trans, conj):
    """B, Bᵀ, conj(B), Bᴴ through the planned and the unplanned wrapper."""
    L = 300
    rng = np.random.RandomState(11)
    bucket = _random_bucket(kind, rng, L=L)
    x = _x(L, 3, 12)
    want = _loop_oracle(bucket, x, trans, conj, L)
    xt = torch.as_tensor(x)
    plan = build_tile_plan_complex(bucket, "s" if trans else "t", L, tile_rows=64)
    assert plan.trans == trans and plan.dtype == torch.complex128
    got = tiled_bucket_matvec(plan, xt, conj=conj).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    in_off, out_off = ((bucket.t_off, bucket.s_off) if trans else (bucket.s_off, bucket.t_off))
    if kind == "dense":
        got = dense_bucket_matvec(bucket.data, in_off, out_off, xt, trans, L, conj=conj)
    else:
        got = lr_bucket_matvec(bucket.U, bucket.V, in_off, out_off, xt, trans, L, conj=conj)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    # out= accumulates
    base = torch.as_tensor(_x(L, 3, 13))
    acc = tiled_bucket_matvec(plan, xt, out=base.clone(), conj=conj)
    np.testing.assert_allclose(acc.numpy(), base.numpy() + want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_build_tile_plan_complex_is_the_ordinary_plan():
    """A complex bucket's plan is the real route's: the dense plan of a dense
    bucket, the split plan of a low-rank one, over the bucket's own complex
    tensors."""
    rng = np.random.RandomState(2)
    dense = _random_bucket("dense", rng)
    bucket = _random_bucket("lr", rng)
    for b, build in ((dense, build_tile_plan), (bucket, build_tile_plan_lr_split)):
        pc = build_tile_plan_complex(b, "t", 300, tile_rows=64)
        pr = build(b, "t", 300, tile_rows=64)
        assert type(pc) is type(pr)
        stages = zip(pc, pr) if isinstance(pc, SplitPlan) else [(pc, pr)]
        for qc, qr in stages:
            for f in dataclasses.fields(qc):
                a, c = getattr(qc, f.name), getattr(qr, f.name)
                assert torch.equal(a, c) if isinstance(a, torch.Tensor) else a == c, f.name
    assert pc.stage_a.data is bucket.V and pc.stage_b.data is bucket.U  # no plane copies
    real = dataclasses.replace(bucket, U=bucket.U.real.contiguous(), V=bucket.V.real.contiguous())
    with pytest.raises(TypeError, match="build_tile_plan_complex"):
        build_tile_plan_complex(real, "t", 300)
    p64 = pc.astype(torch.complex64)
    assert p64.dtype == torch.complex64 and p64.stage_a.blk is pc.stage_a.blk


# ---------------------------------------------------------------------------
# dense export, diagonal, persistence


@pytest.mark.parametrize("name", sorted(CASES))
def test_complex_to_dense_and_diagonal_parity(pairs, name):
    Hj, Ht, A = pairs[name]
    np.testing.assert_array_equal(Ht.to_dense(), np.asarray(Hj.to_dense()))
    assert _rel(Ht.to_dense(), A) < EPS
    if A.shape[0] == A.shape[1]:
        np.testing.assert_allclose(lt.copy_diagonal(Ht).numpy(),
                                   np.asarray(lj.copy_diagonal(Hj)), rtol=1e-14, atol=0)
        np.testing.assert_allclose(lt.copy_diagonal_user(Ht).numpy(), np.diag(A), rtol=1e-12,
                                   atol=0)
    X = _x(A.shape[1], 4, 9)
    want = np.asarray(lj.matmat_user(Hj, jnp.asarray(X)))
    np.testing.assert_allclose(lt.matmat_user(Ht, X).numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("name", ["complex-N", "hermitian-HL"])
def test_complex_plans_save_load_roundtrip(pairs, tmp_path, name):
    """Complex plans survive the port's npz round trip: same schedule over
    the reloaded complex blocks, same products for N, T and C."""
    _, Ht, _ = pairs[name]
    _clear_plans(Ht)
    lt.prepare_tiled_matvec(Ht, tile_rows=128)
    try:
        path = str(tmp_path / "h.npz")
        ot.save_hmatrix(Ht, path)
        back = ot.load_hmatrix(path)
        assert back.dtype == torch.complex128 and back.symmetry == Ht.symmetry
        for ba, bb in zip(_buckets(Ht), _buckets(back)):
            # a pair plan, or a plan for each side
            assert (bb.pair is None) == (bb.plan_t is not None) == (bb.plan_s is not None)
            for field in ("plan_t", "plan_s", "pair"):
                pa, pb = getattr(ba, field), getattr(bb, field)
                assert type(pb) is type(pa)
                if pb is None:
                    continue
                assert pb.dtype == torch.complex128
                if isinstance(pb, PairPlan):  # one plan over the reloaded blocks
                    assert pb.data is (bb.U if pb.kind == "lr" else bb.data)
                    assert pb.V is (bb.V if pb.kind == "lr" else None)
                    stages = []
                    assert torch.equal(pa.items, pb.items) and pa.live == pb.live
                elif pb.kind == "lr_split":  # two stages over the reloaded U and V
                    assert pb.r_pad == pa.r_pad
                    assert {id(pb.stage_a.data), id(pb.stage_b.data)} == {id(bb.U), id(bb.V)}
                    stages = list(zip(pa, pb))
                else:
                    assert pb.data is bb.data
                    stages = [(pa, pb)]
                for qa, qb in stages:
                    for f in dataclasses.fields(qa):
                        va, vb = getattr(qa, f.name), getattr(qb, f.name)
                        assert (torch.equal(va, vb) if isinstance(va, torch.Tensor)
                                else va == vb), f.name
        for op in ("N", "T", "C"):
            x = torch.as_tensor(_x(Ht.shape[1] if op == "N" else Ht.shape[0], 2, 4))
            assert torch.equal(lt.matvec(back, x, op=op), lt.matvec(Ht, x, op=op))
    finally:
        _clear_plans(Ht)


@pytest.mark.parametrize("name", ["complex-symmetric-SL", "hermitian-HU"])
def test_load_complex_file_written_by_jax(pairs, xla_path, tmp_path, name):
    """A complex H-matrix the JAX package saved loads in the port (its plane
    plans are not read) and multiplies like the original."""
    Hj, _, A = pairs[name]
    path = str(tmp_path / "hj.npz")
    oj.save_hmatrix(Hj, path)
    back = ot.load_hmatrix(path)
    assert back.dtype == torch.complex128 and (back.symmetry, back.UPLO) == (Hj.symmetry, Hj.UPLO)
    assert all(b.plan_t is None and b.plan_s is None and b.pair is None for b in _buckets(back))
    x = _x(N, 2, 6)
    for op in ("N", "C"):
        want = np.asarray(lj.matvec_user(Hj, jnp.asarray(x), op=op))
        got = lt.matvec_user(back, x, op=op).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    lt.prepare_tiled_matvec(back)
    assert _rel(lt.matvec_user(back, x).numpy(), A @ x) < 10 * EPS
