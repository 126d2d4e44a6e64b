"""Unplanned bucket matvec of the port against the JAX package: the plain
versions of the Hopper kernels against the Pallas kernels (interpret mode),
products of H-matrices without tiled plans (global and symmetric partition
block rows), ``copy_diagonal_user`` and the mixed low-rank / H-matrix
products of ``lr_linalg``."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import htool_tpu as hj
from htool_tpu.hmatrix import lr_linalg as lj
from htool_tpu.ops import bucket_matvec as bj
from htool_tpu.testing import create_sphere, laplace_kernel_symmetric
from htool_tpu_torch.convert import hmatrix_from_numpy
from htool_tpu_torch.hmatrix import linalg
from htool_tpu_torch.hmatrix import lr_linalg as lt
from htool_tpu_torch.hmatrix.linalg import copy_diagonal_user, matvec, matvec_user
from htool_tpu_torch.ops.bucket_matvec import (
    dense_bucket_matvec,
    dense_bucket_matvec_reference,
    lr_bucket_matvec,
    lr_bucket_matvec_reference,
)
from torch_parity import hmatrix_to_numpy

N, EPS = 700, 1e-5


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


def _random_bucket(rng, kind, trans, k, nb=7, bm=48, bn=40, r=8, L=300):
    out_w, in_w = (bn, bm) if trans else (bm, bn)
    in_off = rng.randint(0, L - in_w, nb)
    out_off = rng.randint(0, L - out_w, nb)
    x = rng.randn(L, k).astype(np.float32)
    if kind == "dense":
        blocks = (rng.randn(nb, bm, bn).astype(np.float32),)
    else:
        blocks = (rng.randn(nb, bm, r).astype(np.float32), rng.randn(nb, r, bn).astype(np.float32))
    return blocks, in_off, out_off, x, L


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("kind", ["dense", "lr"])
def test_reference_matches_pallas_interpret(monkeypatch, kind, trans, k):
    """The plain versions against the Pallas kernels in interpret mode (f32,
    random buckets with overlapping output windows)."""
    blocks, in_off, out_off, x, L = _random_bucket(np.random.RandomState(3), kind, trans, k)
    monkeypatch.setenv("HTOOL_TPU_PALLAS", "interpret")
    jax.clear_caches()
    fj = bj.dense_bucket_matvec if kind == "dense" else bj.lr_bucket_matvec
    yj = np.asarray(fj(*(jnp.asarray(b) for b in blocks), jnp.asarray(in_off, jnp.int32),
                       jnp.asarray(out_off, jnp.int32), jnp.asarray(x), trans, L))
    jax.clear_caches()
    ft = dense_bucket_matvec_reference if kind == "dense" else lr_bucket_matvec_reference
    args = (*(torch.as_tensor(b) for b in blocks), torch.as_tensor(in_off),
            torch.as_tensor(out_off), torch.as_tensor(x), trans, L)
    yt = ft(*args).numpy()
    assert yt.shape == yj.shape == (L, k)
    assert _rel(yt, yj) <= 1e-5
    # on CPU tensors the wrapper is the plain version, and adds into out
    wrapper = dense_bucket_matvec if kind == "dense" else lr_bucket_matvec
    out = torch.ones((L, k))
    got = wrapper(*args, out=out)
    assert got is out
    np.testing.assert_allclose(got.numpy(), yt + 1, rtol=1e-6, atol=1e-6)


def _kernel_walk(blocks, in_off, out_off, x, trans, out_len, in_root, out_root):
    """Block by block in Python, as the one-launch low-rank kernel walks a
    bucket (CTA b applies block b to the window at in_off[b] - in_root and
    adds at row out_off[b] - out_root); the dense route's panels are walked
    in ``test_torch_dense_stream.py``."""
    y = torch.zeros((out_len, x.shape[1]), dtype=x.dtype)
    B = blocks[0] if len(blocks) == 1 else blocks[0] @ blocks[1]
    out_w, in_w = (B.shape[2], B.shape[1]) if trans else (B.shape[1], B.shape[2])
    for b in range(B.shape[0]):
        io, oo = int(in_off[b]) - in_root, int(out_off[b]) - out_root
        assert 0 <= io and io + in_w <= x.shape[0] and 0 <= oo and oo + out_w <= out_len
        y[oo : oo + out_w] += (B[b].T if trans else B[b]) @ x[io : io + in_w]
    return y


@pytest.mark.parametrize("kind", ["dense", "lr"])
def test_kernel_walk_matches_reference_with_roots(kind):
    """Root offsets are subtracted on each side, as a block row's local side
    needs (f64)."""
    rng = np.random.RandomState(5)
    for trans in (False, True):
        blocks, in_off, out_off, x, L = _random_bucket(rng, kind, trans, 2)
        blocks = tuple(torch.as_tensor(b, dtype=torch.float64) for b in blocks)
        x = torch.as_tensor(x, dtype=torch.float64)
        in_off, out_off = torch.as_tensor(in_off) + 100, torch.as_tensor(out_off) + 37
        ref = dense_bucket_matvec_reference if kind == "dense" else lr_bucket_matvec_reference
        got = ref(*blocks, in_off, out_off, x, trans, L, in_root=100, out_root=37)
        want = _kernel_walk(blocks, in_off, out_off, x, trans, L, 100, 37)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


def _jax_hmatrix(dtype, symmetry="N", UPLO="N", **build):
    pts = create_sphere(N).astype(dtype)
    tree = hj.ClusterTreeBuilder(max_leaf_size=32, backend="python").build(
        pts, n_partitions=build.get("n_partitions", 1))
    gen = hj.KernelGenerator(laplace_kernel_symmetric, pts, pts)
    builder = hj.HMatrixBuilder(epsilon=EPS, eta=10.0, symmetry=symmetry, UPLO=UPLO,
                                partition_number_for_symmetry=build.get("p", -1))
    H = builder.build(gen, tree, target_partition=build.get("p", -1))
    return H, tree, gen


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for sym, uplo in (("N", "N"), ("S", "L")):
        Hj, tree, gen = _jax_hmatrix(np.float64, sym, uplo)
        out[sym] = (Hj, hmatrix_from_numpy(hmatrix_to_numpy(Hj)), np.asarray(gen.to_dense()))
    return out


def _terms(H):
    return sum(1 + bool(b.mirror) for b in H.dense_buckets + H.lr_buckets)


@pytest.fixture
def spies(monkeypatch):
    """Count the wrapper calls of matvec (the launches on a GPU)."""
    seen = []
    for name in ("dense_bucket_matvec", "lr_bucket_matvec"):
        real = getattr(linalg, name)

        def spy(*a, _real=real, _name=name, **kw):
            seen.append((_name, a[-3].dtype))  # a[-3] is x_pad
            return _real(*a, **kw)

        monkeypatch.setattr(linalg, name, spy)
    return seen


@pytest.mark.parametrize("op", ["N", "T"])
@pytest.mark.parametrize("sym", ["N", "S"])
def test_unplanned_matvec_parity(pairs, monkeypatch, spies, sym, op):
    """An H-matrix carried across, without plans, gives the JAX package's
    products (its XLA path) to 1e-12 in f64, through the wrappers on every
    term, and the dense oracle's to < ε."""
    Hj, Ht, A = pairs[sym]
    assert (sym == "S") == any(b.mirror for b in Ht.dense_buckets + Ht.lr_buckets)
    monkeypatch.setenv("HTOOL_TPU_PALLAS", "0")
    jax.clear_caches()
    x = np.random.RandomState(7).randn(N, 3)
    want = np.asarray(hj.matvec_user(Hj, jnp.asarray(x), op=op))
    got = matvec_user(Ht, x, op=op).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    assert len(spies) == _terms(Ht)
    assert _rel(got, (A if op == "N" else A.T) @ x) < EPS


@pytest.mark.parametrize("op", ["N", "T"])
def test_symmetric_block_rows_parity(op):
    """Symmetric partition block rows (target_partition=p,
    partition_number_for_symmetry=p) give the JAX block rows' products to
    1e-12 in f64; stacked ('N') or summed ('T') they give A x."""
    P = 4
    pts = create_sphere(N)
    tree = hj.ClusterTreeBuilder(max_leaf_size=32, backend="python").build(pts, n_partitions=P)
    gen = hj.KernelGenerator(laplace_kernel_symmetric, pts, pts)
    perm = np.asarray(tree.permutation)
    Ac = np.asarray(gen.to_dense())[np.ix_(perm, perm)]
    xc = np.random.RandomState(8).randn(N, 2)
    parts, offs = [], []
    for p in range(P):
        Hj = hj.HMatrixBuilder(epsilon=EPS, eta=10.0, symmetry="S", UPLO="L",
                               partition_number_for_symmetry=p).build(gen, tree, target_partition=p)
        Ht = hmatrix_from_numpy(hmatrix_to_numpy(Hj))
        r0, m = Ht.t_root_off, Ht.shape[0]
        offs.append((r0, m))
        xin = xc if op == "N" else xc[r0 : r0 + m]
        want = np.asarray(hj.matvec(Hj, jnp.asarray(xin), op=op))
        got = matvec(Ht, torch.as_tensor(xin), op=op).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
        parts.append(got)
    assert sum(m for _, m in offs) == N and any(r0 > 0 for r0, _ in offs)
    if op == "N":
        y = np.zeros((N, 2))
        for (r0, m), part in zip(offs, parts):
            y[r0 : r0 + m] = part
    else:
        y = sum(parts)
    assert _rel(y, Ac @ xc) < EPS


@pytest.mark.parametrize("sym", ["N", "S"])
def test_copy_diagonal_user_parity(pairs, sym):
    from htool_tpu.hmatrix.linalg import copy_diagonal_user as jax_copy_diagonal_user

    Hj, Ht, A = pairs[sym]
    got = copy_diagonal_user(Ht).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_copy_diagonal_user(Hj)), rtol=1e-12, atol=0)
    np.testing.assert_allclose(got, np.diag(A), rtol=1e-12, atol=0)


def test_copy_diagonal_user_refuses_block_row():
    Hj, _, _ = _jax_hmatrix(np.float64, n_partitions=2, p=1)
    Ht = hmatrix_from_numpy(hmatrix_to_numpy(Hj))
    assert Ht.t_root_off > 0
    with pytest.raises(ValueError, match="global square"):
        copy_diagonal_user(Ht)


def test_matvec_routes_by_dtype(pairs, spies):
    """A complex x against real blocks calls the real wrappers on x viewed as
    real columns (one call per term, float64) and agrees with the real
    products on the real and imaginary parts; a float64 input against
    float32 blocks calls the wrappers on float64 copies."""
    _, Ht, _ = pairs["S"]
    rng = np.random.RandomState(9)
    xr, xi = rng.randn(N, 2), rng.randn(N, 2)
    yr, yi = matvec(Ht, torch.as_tensor(xr)), matvec(Ht, torch.as_tensor(xi))
    spies.clear()
    yc = matvec(Ht, torch.as_tensor(xr + 1j * xi))
    assert len(spies) == _terms(Ht) and {d for _, d in spies} == {torch.float64}
    spies.clear()
    np.testing.assert_allclose(yc.numpy(), (yr + 1j * yi).numpy(), rtol=1e-12, atol=1e-12)
    H32 = hmatrix_from_numpy({**hmatrix_to_numpy(pairs["S"][0]), "dense_buckets": [
        {**b, "data": b["data"].astype(np.float32)} for b in hmatrix_to_numpy(pairs["S"][0])["dense_buckets"]],
        "lr_buckets": [{**b, "U": b["U"].astype(np.float32), "V": b["V"].astype(np.float32)}
                       for b in hmatrix_to_numpy(pairs["S"][0])["lr_buckets"]]})
    y = matvec(H32, torch.as_tensor(xr))
    assert y.dtype == torch.float64 and len(spies) == _terms(H32)


@pytest.mark.parametrize("what", ["meta device", "complex", "mismatched operands"])
def test_wrappers_refuse(what):
    nb, bm, bn = 2, 8, 8
    data = torch.zeros((nb, bm, bn))
    off = torch.zeros(nb, dtype=torch.int64)
    x = torch.zeros((16, 1))
    if what == "meta device":
        with pytest.raises(ValueError, match="unsupported device"):
            dense_bucket_matvec(data.to("meta"), off.to("meta"), off.to("meta"),
                                x.to("meta"), False, 16)
    elif what == "complex":  # complex blocks need an x of their own dtype
        with pytest.raises(TypeError):
            dense_bucket_matvec(data.to(torch.complex64), off, off, x, False, 16)
        with pytest.raises(TypeError):
            lr_bucket_matvec(torch.zeros((nb, bm, 2), dtype=torch.complex128),
                             torch.zeros((nb, 2, bn), dtype=torch.complex128), off, off,
                             x.to(torch.complex64), True, 16)
        with pytest.raises(TypeError):
            dense_bucket_matvec(data.half(), off, off, x.half(),
                                False, 16)
    else:  # blocks and x of different dtypes, and mismatched shapes
        with pytest.raises(TypeError):
            dense_bucket_matvec(data.double(), off, off, x, False, 16)
        with pytest.raises(ValueError):
            dense_bucket_matvec(data, off[:1], off, x, False, 16)


def test_empty_bucket():
    y = torch.ones((16, 2))
    out = lr_bucket_matvec(torch.zeros((0, 8, 4)), torch.zeros((0, 4, 8)),
                           torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.int64),
                           torch.zeros((16, 2)), False, 16, out=y)
    assert out is y and bool((y == 1).all())
    assert lr_bucket_matvec.launches == dense_bucket_matvec.launches == 0  # CPU: no launch


def _arr(m, a):
    return jnp.asarray(a) if m is lj else torch.as_tensor(a)


def _lr(m, d, name):
    return m.LowRank(_arr(m, d[name + "U"]), _arr(m, d[name + "V"]))


# each case: (module, numpy operands, H-matrix) -> result of that module
_LR_CASES = {
    "lrmat_vector_product": lambda m, d, h: m.lrmat_vector_product(_lr(m, d, "a"), _arr(m, d["x"]), op="T"),
    "lrmat_matrix_product": lambda m, d, h: m.lrmat_matrix_product(_lr(m, d, "a"), _arr(m, d["B"])),
    "matrix_lrmat_product": lambda m, d, h: m.matrix_lrmat_product(_arr(m, d["B"].T), _lr(m, d, "b")),
    "lrmat_lrmat_product": lambda m, d, h: m.lrmat_lrmat_product(_lr(m, d, "a"), _lr(m, d, "b")),
    "add_lrmat_lrmat": lambda m, d, h: m.add_lrmat_lrmat(_lr(m, d, "a"), _lr(m, d, "c"), 1e-8),
    "lrmat_from_dense": lambda m, d, h: m.lrmat_from_dense(_arr(m, d["aU"] @ d["aV"]), 1e-10),
    "scale_lrmat": lambda m, d, h: m.scale_lrmat(2.5, _lr(m, d, "a")),
    "matrix_hmatrix_product": lambda m, d, h: m.matrix_hmatrix_product(_arr(m, d["X"]), h),
    "hmatrix_lrmat_product": lambda m, d, h: m.hmatrix_lrmat_product(h, _lr(m, d, "h"), oph="T"),
    "lrmat_hmatrix_product": lambda m, d, h: m.lrmat_hmatrix_product(
        m.LowRank(_arr(m, d["hV"].T), _arr(m, d["hU"].T)), h),
}


@pytest.mark.parametrize("product", sorted(_LR_CASES))
def test_lr_linalg_parity(pairs, spies, product):
    """The mixed products give the JAX package's results to 1e-12 in f64;
    those with an H-matrix operand run through the unplanned wrappers."""
    Hj, Ht, _ = pairs["S"]
    rng = np.random.RandomState(11)
    d = dict(aU=rng.randn(60, 6), aV=rng.randn(6, 50), bU=rng.randn(50, 4), bV=rng.randn(4, 40),
             cU=rng.randn(60, 5), cV=rng.randn(5, 50), x=rng.randn(60, 2), B=rng.randn(50, 30),
             X=rng.randn(9, N), hU=rng.randn(N, 3), hV=rng.randn(3, 20))
    want = _LR_CASES[product](lj, d, Hj)
    got = _LR_CASES[product](lt, d, Ht)
    if isinstance(got, lt.LowRank):
        want, got = want.U @ want.V, got.U @ got.V
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    assert len(spies) == (_terms(Ht) if "hmatrix" in product else 0)
