"""The unplanned dense route of the port on the streaming core.

(a) ``cut_rule`` covers every entry of a dense block exactly once, at the
dense shapes the symmetric path produces (multiples of 32 up to 256, odd
tails), float32 to complex128, N and T; (b) a Python walk of the route's
slots and panels (slot -> block and panel, root offsets) against
``dense_bucket_matvec_reference`` and the JAX ``dense_bucket_matvec``
(Pallas interpret mode; complex modes on real and imaginary planes, as the
JAX package computes complex products), for N, T, C and conj; (c) a float64
emulation of the FP64 tensor-core loop of ``csrc/matvec_stream.cuh``
(m16n8k fragments lane by lane, the complex128 real expansion with its conj
signs, the T side's recombination of fragment rows) against the complex
product, so the signs are pinned before the card runs them."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

import jax
import jax.numpy as jnp
from hypothesis import given, settings
from hypothesis import strategies as st

from htool_tpu.ops import bucket_matvec as bj
from htool_tpu_torch.ops import bucket_matvec as bucket_ops
from htool_tpu_torch.ops.bucket_matvec import dense_bucket_matvec, dense_bucket_matvec_reference
from htool_tpu_torch.ops.cut import cut_rule, panels

import torch_parity  # noqa: F401  (the port's default device: the CPU)

# the dense block sides of the symmetric path at leaf 256, and odd tails
SIDES = [32 * i for i in range(1, 9)] + [1, 7, 37, 101, 255]


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(nb=st.integers(1, 3000), bm=st.sampled_from(SIDES), bn=st.sampled_from(SIDES),
       itemsize=st.sampled_from([4, 8, 16]), trans=st.booleans())
def test_cut_rule_covers_every_dense_entry_once(nb, bm, bn, itemsize, trans):
    """Slot v = b·P + p of CTA v // G streams panel p of block b: rows
    [lo, hi) of D (N) or columns [lo, hi) (T), the whole other dimension.
    Every block's output extent is covered exactly once, so every entry is;
    a slab of a transposed block is at most 256 columns on 16-byte
    boundaries."""
    P, cut, G = cut_rule(nb, bm, bn, itemsize, trans)
    ext = bn if trans else bm
    assert P == -(-ext // cut) and 1 <= cut <= ext and 1 <= G <= 32
    if trans:
        assert cut <= 256 and (P == 1 or cut * itemsize % 16 == 0)
    spans = panels(ext, P, cut)
    count = np.zeros((nb, ext), np.int64)
    n_slots = nb * P
    for cta in range(-(-n_slots // G)):
        for v in range(cta * G, min(n_slots, (cta + 1) * G)):
            b, p = divmod(v, P)
            lo, hi = spans[p]
            count[b, lo:hi] += 1
    assert (count == 1).all()


def _dense_walk(data, in_off, out_off, x, trans, out_len, in_root, out_root, conj):
    """The streaming dense route in Python: the wrapper's cut, CTA c taking
    slots [c·G, (c+1)·G), slot v = b·P + p applying panel p of block b to
    the window at in_off[b] - in_root and adding at row out_off[b] - out_root
    + lo."""
    nb, bm, bn = data.shape
    P, cut, G = bucket_ops._dense_route(nb, bm, bn, data.element_size(), trans)
    ext, in_w = (bn, bm) if trans else (bm, bn)
    spans = panels(ext, P, cut)
    y = torch.zeros((out_len, x.shape[1]), dtype=x.dtype)
    for cta in range(-(-nb * P // G)):
        for v in range(cta * G, min(nb * P, (cta + 1) * G)):
            b, p = divmod(v, P)
            lo, hi = spans[p]
            io, oo = int(in_off[b]) - in_root, int(out_off[b]) - out_root + lo
            assert 0 <= io and io + in_w <= x.shape[0] and 0 <= oo and oo + hi - lo <= out_len
            D = data[b].conj() if conj else data[b]
            panel = D[:, lo:hi].T if trans else D[lo:hi, :]
            y[oo : oo + hi - lo] += panel @ x[io : io + in_w]
    return y


def _jax_dense(monkeypatch, data, in_off, out_off, x, trans, out_len, conj):
    """The JAX package's Pallas kernel in interpret mode, float32; a complex
    term as four real products on the real and imaginary planes."""
    monkeypatch.setenv("HTOOL_TPU_PALLAS", "interpret")
    jax.clear_caches()

    def run(d, xx):
        return np.asarray(bj.dense_bucket_matvec(
            jnp.asarray(d, jnp.float32), jnp.asarray(in_off, jnp.int32),
            jnp.asarray(out_off, jnp.int32), jnp.asarray(xx, jnp.float32), trans, out_len))

    if not np.iscomplexobj(data):
        y = run(data, x)
    else:
        s = -1.0 if conj else 1.0
        dr, di, xr, xi = data.real, data.imag, x.real, x.imag
        y = (run(dr, xr) - s * run(di, xi)) + 1j * (run(dr, xi) + s * run(di, xr))
    jax.clear_caches()
    return y


# (bm, bn, nb): many 32-multiple blocks with odd tails (P = 1, G > 1), and
# few wide ones that the cut splits into panels or slabs (P > 1)
WALK_SHAPES = {"grouped": (64, 37, 30), "panels": (256, 224, 3)}


@pytest.mark.parametrize("shape", sorted(WALK_SHAPES))
@pytest.mark.parametrize("mode", ["N", "T", "C", "conj"])
def test_dense_walk_matches_reference_and_jax(monkeypatch, mode, shape):
    bm, bn, nb = WALK_SHAPES[shape]
    trans, conj = mode in ("T", "C"), mode in ("C", "conj")
    rng = np.random.RandomState(4)
    L, in_root, out_root = 900, 50, 13
    in_w, out_w = (bm, bn) if trans else (bn, bm)
    in_off = rng.randint(0, L - in_w, nb) + in_root
    out_off = rng.randint(0, L - out_w, nb) + out_root
    complex_ = mode in ("C", "conj")
    data = rng.randn(nb, bm, bn) + (1j * rng.randn(nb, bm, bn) if complex_ else 0)
    x = rng.randn(L, 3) + (1j * rng.randn(L, 3) if complex_ else 0)
    dt = torch.complex128 if complex_ else torch.float64
    args = (torch.as_tensor(data, dtype=dt), torch.as_tensor(in_off), torch.as_tensor(out_off),
            torch.as_tensor(x, dtype=dt), trans, L)
    want = dense_bucket_matvec_reference(*args, in_root=in_root, out_root=out_root, conj=conj)
    got = _dense_walk(*args, in_root, out_root, conj)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    P = bucket_ops._dense_route(nb, bm, bn, args[0].element_size(), trans)[0]
    assert P > 1 or shape == "grouped"
    # the wrapper on CPU tensors is the plain version
    np.testing.assert_array_equal(
        dense_bucket_matvec(*args, in_root=in_root, out_root=out_root, conj=conj).numpy(),
        want.numpy())
    yj = _jax_dense(monkeypatch, data, in_off - in_root, out_off - out_root, x, trans, L, conj)
    assert np.linalg.norm(got.numpy() - yj) / np.linalg.norm(yj) <= 1e-5


# ---------------------------------------------------------------------------
# (c) the FP64 tensor-core loop, lane by lane


def _mma(d, a, b, KS):
    """mma.sync m16n8kKS f64 over a warp: lane 4 g + t holds a[lane][i] =
    A[g + 8 (i % 2)][t + 4 (i // 2)] and b[lane][i] = B[t + 4 i][g]; d[lane]
    is D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1], updated."""
    A, B = np.zeros((16, KS)), np.zeros((KS, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        for i in range(KS // 2):
            A[g + 8 * (i % 2), t + 4 * (i // 2)] = a[lane][i]
        for i in range(KS // 4):
            B[t + 4 * i, g] = b[lane][i]
    D = A @ B
    for lane in range(32):
        g, t = divmod(lane, 4)
        d[lane] += [D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1]]


def _frag_b(x, kr, kv, nt, g, cj, trans, complex_):
    """frag_b_n (trans False) / frag_b_t of matvec_stream.cuh; x [rows, KC]
    is the staged slot, kr the K index (N: a real of the tile row; T: a
    tile row)."""
    KC = x.shape[1]
    if not complex_:
        j = nt * 8 + g
        return x[kr, j] if kv and j < KC else 0.0
    j = nt * 4 + (g >> 1)
    if not kv or j >= KC:
        return 0.0
    if trans:
        v = x[kr, j]
        return v.imag if g & 1 else v.real
    p, q = kr & 1, g & 1
    v = (x[kr >> 1, j].real, x[kr >> 1, j].imag)[p ^ q]
    return -v if p and (q == 0) != bool(cj) else v


def _mma_loop(A, x, trans, cj, KS, kg):
    """op(A) x through the tensor-core loop: m16 tiles of A's rows (N) or of
    the slab's reals (T); K (N: the row's reals; T: A's rows) in steps of KS
    dealt to kg warp groups whose sums are added as the shared-memory
    reduction adds them; T complex: lanes add their partner's (lane ^ 4)
    fragment rows.  Masks as in the kernel: zero past K and M, rows past R
    clamped and not written."""
    complex_ = np.iscomplexobj(A)
    NC = 2 if complex_ else 1
    R, C = A.shape
    KC = x.shape[1]
    NTL = -(-KC * NC // 8)
    Ar = A.view(np.float64).reshape(R, C * NC) if complex_ else A  # the tile's reals
    out = np.zeros((C if trans else R, KC), A.dtype)
    M, K = (C * NC, R) if trans else (R, C * NC)
    for m0 in range(0, M, 16):
        acc = np.zeros((NTL, 32, 4))
        for grp in range(kg):
            part = np.zeros((NTL, 32, 4))
            for kk in range(KS * grp, K, KS * kg):
                a, bf = np.zeros((32, KS // 2)), np.zeros((NTL, 32, KS // 4))
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for q in range(KS // 4):
                        kr = kk + t + 4 * q
                        kv = kr < K
                        for h in range(2):
                            m = m0 + 8 * h + g
                            if trans:
                                a[lane, 2 * q + h] = Ar[kr, m] if kv and m < M else 0.0
                            else:
                                a[lane, 2 * q + h] = Ar[min(m, R - 1), kr] if kv else 0.0
                        for nt in range(NTL):
                            bf[nt, lane, q] = _frag_b(x, kr, kv, nt, g, cj, trans, complex_)
                for nt in range(NTL):
                    _mma(part[nt], a, bf[nt], KS)
            acc += part
        for nt in range(NTL):
            if trans and complex_:
                p = acc[nt, np.arange(32) ^ 4].copy()  # the partner lane's fragment
                for h in range(2):
                    acc[nt, :, 2 * h] += p[:, 2 * h + 1] if cj else -p[:, 2 * h + 1]
                    acc[nt, :, 2 * h + 1] += -p[:, 2 * h] if cj else p[:, 2 * h]
            for lane in range(32):
                g, t = divmod(lane, 4)
                for h in range(2):
                    m = m0 + 8 * h + g
                    if trans and complex_:
                        c, j = m >> 1, nt * 4 + t
                        if not g & 1 and c < C and j < KC:
                            out[c, j] += acc[nt, lane, 2 * h] + 1j * acc[nt, lane, 2 * h + 1]
                        continue
                    if m >= M:
                        continue
                    row = out[m].view(np.float64) if complex_ else out[m]
                    for e in range(2):
                        idx = nt * 8 + 2 * t + e
                        if idx < KC * NC:
                            row[idx] += acc[nt, lane, 2 * h + e]
    return out


@pytest.mark.parametrize("KC,KS,kg", [(4, 16, 2), (8, 16, 1), (8, 16, 8)])
@pytest.mark.parametrize("dtype,mode", [("float64", "N"), ("float64", "T"),
                                        *(("complex128", m) for m in ("N", "T", "C", "conj"))])
def test_tensor_core_loop_emulation(dtype, mode, KC, KS, kg):
    """The fragments, signs and recombination of the FP64 tensor-core loop
    give op(A) x to 1e-13 (odd sides: the masked tails of M and K; kg warp
    groups splitting K)."""
    rng = np.random.RandomState(6)
    R, C = 21, 19
    A = rng.randn(R, C)
    trans, cj = mode in ("T", "C"), mode in ("C", "conj")
    x = rng.randn(C if not trans else R, KC)
    if dtype == "complex128":
        A = A + 1j * rng.randn(R, C)
        x = x + 1j * rng.randn(*x.shape)
    op = A.conj() if cj else A
    want = (op.T if trans else op) @ x
    got = _mma_loop(A, x, trans, cj, KS, kg)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-13
