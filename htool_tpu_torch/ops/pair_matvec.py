"""The pair pass of the symmetric product: a mirror bucket's blocks and their
mirrors in one launch.

Symmetric ('S') and hermitian ('H') storage keeps one block A of each
mirrored pair, at (t, s), and a product applies it twice: as itself into
y's rows at t, and mirrored, transposed, into y's rows at s.  With per-term
plans (:mod:`.tiled_matvec`) that is two walks over the bucket, a dense
term one launch each and a low-rank term two stages each, and every stored
coefficient is fetched twice.  A :class:`PairPlan` applies both::

    y[t :] += g1(A) x[s :]        y[s :] += g2(A)ᵀ x[t :]

(g1, g2 the identity or conj, as ``linalg._bucket_terms`` gives them for
the op and the symmetry) in one launch of ``csrc/pair_matvec.cu`` that
fetches each live coefficient once.  x and y are the product's padded
vectors; the operator is global and square, so rows at t and at s index the
same vectors.

- A dense bucket's items are row panels of its blocks, ``tile_rows`` rows
  (a tile of about ``_TILE_BYTES``), each taken with its block's live
  columns: the kernel takes the panel's row sums into y at t and its column
  sums into y at s from one staged copy.
- A low-rank bucket's items are its blocks (A = U V, at live rows, columns
  and rank): a rank pass t = g1(V) x[s :], t' = g2(U)ᵀ x[t :], then an
  expansion pass y[t :] += g1(U) t, y[s :] += g2(V)ᵀ t', with the factors
  held in shared memory between them.  A block too large for one CTA is
  spread over a thread-block cluster of ``cs`` CTAs (at most 8): each holds
  a row panel of U and a column slab of V, and the partial t, t' meet
  through distributed shared memory.

How a launch is laid out (:func:`_geometry`) follows from the plan's
largest live extent, the dtype and the launch's column chunk KC (1, 2, 4 or
8, from k): the cluster size ``cs``, the number of buffers (two where they
fit, so that the next item's copies fly during the current one) and the
items a CTA walks ``G`` (by bytes, as :func:`.cut.cut_rule` groups slots).
:func:`build_pair_plan` returns None for a bucket the pass does not take,
which keeps its per-term plans: a low-rank bucket whose live factors at
KC = 8 do not fit the shared memory of a cluster of 8 CTAs, or a dense
bucket whose live rows do not fit a tile of ``_MIN_TILE_ROWS`` rows.

CUDA tensors launch the kernel; CPU tensors run
:func:`pair_bucket_matvec_reference`, which walks the same items.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils.profiling import count

__all__ = ["PairPlan", "build_pair_plan", "pair_bucket_matvec", "pair_bucket_matvec_reference"]

_NT = 256  # threads of a CTA (csrc/matvec_scalar.cuh)
_ITEM_INTS = 8  # an item: block, lo, hi, t_off, s_off, cols, rank, unused
_GROUP_MAX = 32  # items of one CTA at most
_CTA_BYTES = 32 * 1024  # live bytes a CTA should fetch (the sweep's best: 26 - 54 KB)
# a dense item's tile at most: whole blocks of the benchmark's operators
# (leaf 100; complex64 at k = 8 340 against 393 us with 40 KB tiles of half
# blocks, float32 at k = 1 alike, on an H100: PERF.md section 5)
_TILE_BYTES = 96 * 1024
_MIN_TILE_ROWS = 4  # a dense bucket whose tile would be thinner keeps its per-term plans
# dynamic shared memory of a CTA: at most 227 KB less its 1 KB of static
# memory; two CTAs share an SM's 228 KB (less static and reserved) below 110
_SMEM_TWO = 110 * 1024
_SMEM_MAX = 225 * 1024
_SECTOR = 32


@dataclass
class PairPlan:
    """One launch over a mirror bucket: every block and its mirror.

    ``items`` [n_items, 8] int32: block, first and end row of the item's
    panel (a low-rank item: 0 and the block's live rows), the block's
    offsets t and s, its live columns and live rank (0 for a dense block),
    sorted by t.  ``rows``, ``cols``, ``rank``: the largest live extent over
    the items (a dense item's rows are at most ``tile_rows``)."""

    kind: str  # "dense" or "lr"
    data: torch.Tensor  # dense blocks [nb, R, C], or U [nb, R, r]
    V: Optional[torch.Tensor]  # low rank: [nb, r, C]
    items: torch.Tensor
    n_items: int
    tile_rows: int  # dense: rows of an item at most
    rows: int
    cols: int
    rank: int
    live: int  # bytes of the items' live coefficients at the plan's dtype
    out_len: int

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def in_end(self) -> int:
        return self.out_len

    def astype(self, dtype: torch.dtype) -> Optional["PairPlan"]:
        """The same items over the blocks cast to ``dtype`` (a dense plan's
        panels cut again for the new element size), or None where no layout
        of the wider elements fits at KC = 8, as :func:`build_pair_plan`
        would have found."""
        data = self.data.to(dtype)
        if self.kind == "dense":
            return _dense_plan(data, _blocks_of(self), self.out_len)
        V = self.V.to(dtype)
        live = self.live // self.data.element_size() * data.element_size()
        plan = dataclasses.replace(self, data=data, V=V, live=live)
        plan._items_host = _host_items(self)
        return plan if _geometry(plan, 8) is not None else None

    def streamed_bytes(self, k: int = 1) -> int:
        """Bytes one launch at k columns fetches from the blocks: each live
        coefficient once, every row's run (a cluster's piece of a V row
        alone) in whole 32-byte sectors."""
        return _geometry(self, _kc(k))[1]


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _stride(n: int, per: int) -> int:
    """Row stride in shared memory, in scalars, for rows of n: an odd number
    of 16-byte units (lanes on consecutive rows meet no bank twice)."""
    u = max(1, -(-n // per))
    return (u if u % 2 else u + 1) * per


def _kc(k: int) -> int:
    """The kernel's column chunk for k columns (csrc/pair_matvec.cu)."""
    return 1 if k == 1 else 2 if k == 2 else 4 if k <= 4 else 8


def _runs(n, item: int) -> np.ndarray:
    """Bytes of row runs of n entries in whole 32-byte sectors."""
    return -(-np.asarray(n, np.int64) * item // _SECTOR) * _SECTOR


def _live_sizes(bucket, nb: int, R: int, C: int, r: int):
    """(rows, cols, rank) int64 [nb] of each block, clipped to the storage
    (whole blocks where the bucket does not know its sizes)."""
    def get(name, full):
        a = getattr(bucket, name, None)
        a = np.full(nb, full, np.int64) if a is None else np.asarray(a, np.int64).reshape(-1)
        return np.clip(a, 0, full) if a.shape == (nb,) else np.full(nb, full, np.int64)

    return get("t_sizes", R), get("s_sizes", C), get("ranks", r)


@dataclass
class _Blocks:
    """What a plan keeps of its bucket to cut its items again."""
    t_off: np.ndarray
    s_off: np.ndarray
    rows: np.ndarray
    cols: np.ndarray
    ranks: np.ndarray


def _host_items(plan: PairPlan) -> np.ndarray:
    """The plan's items as int64 on the host (kept from the build; else
    copied from the device once)."""
    it = plan.__dict__.get("_items_host")
    if it is None:
        it = plan.__dict__["_items_host"] = plan.items.cpu().numpy().astype(np.int64)
    return it


def _blocks_of(plan: PairPlan) -> _Blocks:
    """The blocks a dense plan's items cut (rows: the end of a block's last
    panel)."""
    it = _host_items(plan)
    nb = int(plan.data.shape[0])
    out = [np.zeros(nb, np.int64) for _ in range(5)]
    t_off, s_off, rows, cols, ranks = out
    b = it[:, 0]
    t_off[b], s_off[b], cols[b] = it[:, 3], it[:, 4], it[:, 5]
    np.maximum.at(rows, b, it[:, 2])
    return _Blocks(t_off, s_off, rows, cols, ranks)


def _items(blocks: _Blocks, lo, b, hi, rank) -> np.ndarray:
    """[n, 8] int64 items sorted by t, then by first row."""
    order = np.lexsort((lo, blocks.t_off[b]))
    b, lo, hi, rank = b[order], lo[order], hi[order], rank[order]
    it = np.zeros((b.size, _ITEM_INTS), np.int64)
    it[:, 0], it[:, 1], it[:, 2] = b, lo, hi
    it[:, 3], it[:, 4], it[:, 5], it[:, 6] = blocks.t_off[b], blocks.s_off[b], blocks.cols[b], rank
    return it


def _planned(items: np.ndarray, **kw) -> PairPlan:
    """A plan over ``items``, which it keeps on the host too."""
    plan = PairPlan(items=torch.as_tensor(items.astype(np.int32), device=kw["data"].device),
                    n_items=len(items), **kw)
    plan._items_host = items
    return plan


def _dense_plan(data: torch.Tensor, blocks: _Blocks, out_len: int) -> Optional[PairPlan]:
    nb, R, C = (int(s) for s in data.shape)
    item = data.element_size()
    cmax = int(blocks.cols.max(initial=0))
    rmax = int(blocks.rows.max(initial=0))
    tr = _TILE_BYTES // (_stride(max(cmax, 1), 16 // item) * item)
    if tr < _MIN_TILE_ROWS:
        return None
    tr = -(-max(rmax, 1) // -(-max(rmax, 1) // tr))  # even panels
    live = (blocks.rows > 0) & (blocks.cols > 0)
    n_p = np.where(live, -(-blocks.rows // tr), 0)
    b = np.repeat(np.arange(nb, dtype=np.int64), n_p)
    lo = (np.arange(b.size, dtype=np.int64) - np.repeat(np.cumsum(n_p) - n_p, n_p)) * tr
    hi = np.minimum(lo + tr, blocks.rows[b])
    plan = _planned(_items(blocks, lo, b, hi, np.zeros_like(b)), kind="dense", data=data,
                    V=None, tile_rows=tr, rows=min(tr, rmax), cols=cmax, rank=0,
                    live=int(np.sum((hi - lo) * blocks.cols[b])) * item, out_len=out_len)
    return plan if _geometry(plan, 8) is not None else None


def build_pair_plan(bucket, out_len: int) -> Optional[PairPlan]:
    """The pair plan of a mirror bucket (dense or low rank) of a global
    square operator whose padded vectors have ``out_len`` rows, or None where
    the pass does not take the bucket (see the module note): it then keeps
    its per-term plans."""
    dense = getattr(bucket, "data", None) is not None
    A = bucket.data if dense else bucket.U
    nb, R = int(A.shape[0]), int(A.shape[1])
    C = int(A.shape[2]) if dense else int(bucket.V.shape[2])
    r = 0 if dense else int(A.shape[2])
    t_off = torch.as_tensor(bucket.t_off).cpu().numpy().astype(np.int64)
    s_off = torch.as_tensor(bucket.s_off).cpu().numpy().astype(np.int64)
    rows, cols, ranks = _live_sizes(bucket, nb, R, C, r)
    blocks = _Blocks(t_off, s_off, rows, cols, ranks)
    if nb and max(int(t_off.max()) + R, int(s_off.max()) + C) > out_len:
        raise ValueError(f"blocks reach past out_len {out_len}")
    if dense:
        return _dense_plan(A, blocks, out_len)
    b = np.nonzero((rows > 0) & (cols > 0) & (ranks > 0))[0].astype(np.int64)
    item = A.element_size()
    plan = _planned(_items(blocks, np.zeros_like(b), b, rows[b], ranks[b]), kind="lr", data=A,
                    V=bucket.V, tile_rows=0, rows=int(rows[b].max(initial=0)),
                    cols=int(cols[b].max(initial=0)), rank=int(ranks[b].max(initial=0)),
                    live=int(np.sum(ranks[b] * (rows[b] + cols[b]))) * item, out_len=out_len)
    return plan if _geometry(plan, 8) is not None else None


def _layout(plan: PairPlan, KC: int, item: int, cs: int) -> dict:
    """Shared-memory layout of a launch, in scalars (csrc/pair_matvec.cu's
    PairGeom); every region a whole number of 16-byte units."""
    per = 16 // item
    if plan.kind == "dense":
        mr, mc = plan.tile_rows, max(plan.cols, 1)
        sa, sv, rv = _stride(mc, per), 0, 0
    else:
        mr = -(-max(plan.rows, 1) // cs)
        mc = _up(-(-max(plan.cols, 1) // cs), per)
        rv = max(plan.rank, 1)
        sa, sv = _stride(rv, per), _stride(mc, per)
    xrt, xrs, xrr = _up(mr, per), _up(mc, per), _up(max(plan.rank, 1), per)
    offV = mr * sa
    offXt = offV + rv * sv
    offXs = offXt + KC * xrt
    buf = offXs + KC * xrs
    offPart = buf
    offFull = offPart + (4 * KC * xrr if plan.kind == "lr" else 0)
    offRed = offFull + (2 * KC * xrr if plan.kind == "lr" else 0)
    smem = (offRed + _NT * KC) * item
    return dict(mr=mr, mc=mc, sa=sa, sv=sv, xrt=xrt, xrs=xrs, xrr=xrr, offV=offV, offXt=offXt,
                offXs=offXs, buf=buf, offPart=offPart, offFull=offFull, offRed=offRed,
                smem=smem)


_GEOM = ("R", "C", "r", "cs", "G", "n_items", "mr", "mc", "sa", "sv", "xrt", "xrs", "xrr",
         "offV", "offXt", "offXs", "buf", "offPart", "offFull", "offRed", "vecA", "vecV", "smem",
         "KC")


def _geometry(plan: PairPlan, KC: int):
    """(PairGeom ints, bytes a launch fetches from the blocks) of a launch at
    column chunk KC, or None where no layout fits (see :func:`_pick`)."""
    cached = plan.__dict__.setdefault("_geom", {})
    if KC not in cached:
        cs = _pick(plan, KC)
        cached[KC] = None if cs is None else _laid_out(plan, KC, cs)
    return cached[KC]


def _pick(plan: PairPlan, KC: int):
    """The cluster size of a launch at KC, or None: the smallest whose CTAs
    two share an SM, else the smallest that fits one CTA an SM.  A walk at
    k = 1 is paced by the latency of its steps, so resident CTAs hide more
    of it than a second buffer of a CTA's own, and a smaller cluster waits
    at fewer barriers (the benchmark's operator on an H100,
    ``tools/torch_term_probe.py --sweep``: PERF.md section 5)."""
    item = plan.data.element_size()
    for cap in (_SMEM_TWO, _SMEM_MAX):
        for cs in (1, 2, 4, 8) if plan.kind == "lr" else (1,):
            if _layout(plan, KC, item, cs)["smem"] <= cap:
                return cs
    return None


def _laid_out(plan: PairPlan, KC: int, cs: int):
    """(PairGeom ints, bytes fetched) of a launch at KC with cluster size
    cs; G items a CTA, about ``_CTA_BYTES`` of live coefficients."""
    item = plan.data.element_size()
    lr = plan.kind == "lr"
    lay = _layout(plan, KC, item, cs)
    per = plan.live / max(plan.n_items, 1) / cs  # bytes a CTA fetches for an item
    G = max(1, min(_GROUP_MAX, round(_CTA_BYTES / max(per, 1))))
    A, V = plan.data, plan.V
    R, C = int(A.shape[1]), int(A.shape[2]) if not lr else int(V.shape[2])
    r = int(A.shape[2]) if lr else 0
    geom = dict(R=R, C=C, r=r, cs=cs, G=G, n_items=plan.n_items, KC=KC, **lay,
                vecA=int((r if lr else C) * item % 16 == 0 and A.data_ptr() % 16 == 0),
                vecV=int(lr and C * item % 16 == 0 and V.data_ptr() % 16 == 0))
    return tuple(int(geom[f]) for f in _GEOM), _read_bytes(plan, lay["mc"], cs, item)


def _read_bytes(plan: PairPlan, mc: int, cs: int, item: int) -> int:
    it = _host_items(plan)
    rows, cols, rank = it[:, 2] - it[:, 1], it[:, 5], it[:, 6]
    if plan.kind == "dense":
        return int(np.sum(rows * _runs(cols, item)))
    slabs = np.clip(cols[:, None] - np.arange(cs)[None, :] * mc, 0, mc)  # V's pieces a row
    v = rank * np.where(slabs > 0, _runs(slabs, item), 0).sum(axis=1)
    return int(np.sum(rows * _runs(rank, item) + v))


def _masked(M: torch.Tensor, nrows, ncols) -> torch.Tensor:
    """M [c, a, b] with entries at rows >= nrows or columns >= ncols (per
    matrix) zero: nothing past the live extent is used."""
    dev = M.device
    keep = ((torch.arange(M.shape[1], device=dev)[None, :] < nrows[:, None])[:, :, None]
            & (torch.arange(M.shape[2], device=dev)[None, :] < ncols[:, None])[:, None, :])
    return torch.where(keep, M, torch.zeros((), dtype=M.dtype, device=dev))


_REF_CHUNK_BYTES = 1 << 28


def pair_bucket_matvec_reference(plan: PairPlan, x_pad: torch.Tensor,
                                 out: Optional[torch.Tensor] = None, conj_t: bool = False,
                                 conj_s: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the pair kernel, item by item in chunks:
    gather the items' blocks (a dense item's panel) at their live extent and
    x's windows at t and s, batched matmuls, ``index_add_`` into y at t and
    at s.  Returns y [out_len, k], added into ``out`` when it is given."""
    dev, k = x_pad.device, x_pad.shape[1]
    y = out if out is not None else torch.zeros((plan.out_len, k), dtype=x_pad.dtype, device=dev)
    if plan.n_items == 0:
        return y
    it = plan.items.to(dev).long()
    A = plan.data
    R, C = A.shape[1], (A.shape[2] if plan.kind == "dense" else plan.V.shape[2])
    width = plan.tile_rows if plan.kind == "dense" else R
    per = (width * C + (A.shape[2] * (R + C) if plan.kind == "lr" else 0)) * x_pad.element_size()
    step = max(1, _REF_CHUNK_BYTES // max(1, per))
    ar_r, ar_c = torch.arange(width, device=dev), torch.arange(C, device=dev)

    def g(M, cj):
        M = M.to(x_pad.dtype)
        return M.conj() if cj else M

    for c0 in range(0, plan.n_items, step):
        b, lo, hi, t0, s0, nc, rk = it[c0:c0 + step, :7].unbind(1)
        nr = hi - lo
        rmask = ar_r[None, :] < nr[:, None]
        t_rows = torch.where(rmask, t0[:, None] + lo[:, None] + ar_r, t0[:, None])
        s_rows = s0[:, None] + ar_c
        xt, xs = x_pad[t_rows], x_pad[s_rows]  # [c, width, k], [c, C, k]
        if plan.kind == "dense":
            rows = torch.clamp(lo[:, None] + ar_r, max=R - 1)
            D = _masked(A[b[:, None], rows], nr, nc)
            yt = g(D, conj_t) @ xs
            ys = g(D, conj_s).transpose(1, 2) @ xt
        else:
            U = _masked(A[b], nr, rk)
            Vb = _masked(plan.V[b], rk, nc)
            yt = g(U, conj_t) @ (g(Vb, conj_t) @ xs)
            ys = g(Vb, conj_s).transpose(1, 2) @ (g(U, conj_s).transpose(1, 2) @ xt)
        y.index_add_(0, t_rows.reshape(-1), yt.reshape(-1, k))
        y.index_add_(0, s_rows.reshape(-1), ys.reshape(-1, k))
    return y


@functools.lru_cache(maxsize=None)
def _geom_ints_checked() -> bool:
    from ..kernels import load_library

    n = load_library().htool_pair_geom_ints()
    if n != len(_GEOM):
        raise RuntimeError(f"pair kernel takes {n} geometry ints, the host gives {len(_GEOM)}")
    return True


def _launch_args(plan: PairPlan, x_pad: torch.Tensor, KC: int):
    """Validate a plan's tensors once per device, dtype and KC, and cache
    the constant arguments of its kernel call."""
    key = (x_pad.device, x_pad.dtype, KC)
    cached = plan.__dict__.setdefault("_args", {})
    if key in cached:
        return cached[key]
    tensors = [plan.data, plan.items] + ([plan.V] if plan.V is not None else [])
    for t in tensors:
        if t.device != x_pad.device or not t.is_contiguous():
            raise ValueError(f"pair_bucket_matvec: plan tensors must be contiguous and on "
                             f"{x_pad.device}")
    if plan.data.dtype != x_pad.dtype or (plan.V is not None and plan.V.dtype != x_pad.dtype):
        raise TypeError(f"pair_bucket_matvec: blocks are {plan.data.dtype}, x is {x_pad.dtype}")
    from ..kernels import entry_point

    _geom_ints_checked()
    ints, _ = _geometry(plan, KC)
    geom = (ctypes.c_int * len(ints))(*ints)
    cached[key] = (entry_point("htool_pair_matvec", x_pad.dtype), geom,
                   int(plan.kind == "lr"), plan.data.data_ptr(),
                   None if plan.V is None else plan.V.data_ptr(), plan.items.data_ptr())
    return cached[key]


def pair_bucket_matvec(plan: PairPlan, x_pad: torch.Tensor, out: Optional[torch.Tensor] = None,
                       conj_t: bool = False, conj_s: bool = False) -> torch.Tensor:
    """Apply a mirror bucket and its mirrors: ``y[t :] += g1(A) x[s :]`` and
    ``y[s :] += g2(A)ᵀ x[t :]`` for every block A, g1 conj where ``conj_t``,
    g2 conj where ``conj_s``.  Returns y [out_len, k], added into ``out`` (a
    contiguous [out_len, k] tensor) when it is given.

    CUDA tensors launch the kernel (float32, float64, complex64 or
    complex128, x's dtype the plan's); CPU tensors run the plain version.
    Each call that goes to the GPU adds one to ``pair_bucket_matvec.launches``,
    ``cuda_launches``, ``launches_by_dtype[dtype]`` and ``launches_by_k``; a
    call on the CPU adds one to the process counter ``plain_calls``.  Every
    call adds what its launch fetches from the blocks
    (:meth:`PairPlan.streamed_bytes`) to ``product_read_bytes``."""
    if x_pad.ndim != 2:
        raise ValueError("pair_bucket_matvec: x_pad must be a [L, k] tensor")
    k = int(x_pad.shape[1])
    KC = _kc(k)
    count("product_read_bytes", _geometry(plan, KC)[1])
    if x_pad.device.type == "cpu":
        count("plain_calls")
        return pair_bucket_matvec_reference(plan, x_pad, out, conj_t, conj_s)
    if x_pad.device.type != "cuda":
        raise ValueError(f"pair_bucket_matvec: unsupported device {x_pad.device}")
    dtype = x_pad.dtype
    if not x_pad.is_contiguous() or x_pad.shape[0] < plan.in_end:
        raise ValueError(f"pair_bucket_matvec: x_pad must be a contiguous tensor of at least "
                         f"{plan.in_end} rows")
    if out is None:
        out = torch.zeros((plan.out_len, k), dtype=dtype, device=x_pad.device)
    elif (tuple(out.shape) != (plan.out_len, k) or out.dtype != dtype
          or out.device != x_pad.device or not out.is_contiguous()):
        raise ValueError(f"pair_bucket_matvec: out must be a contiguous {dtype} "
                         f"[{plan.out_len}, {k}] tensor on {x_pad.device}")
    from ..kernels import count_launch, launch

    fn, geom, lr, a, v, items = _launch_args(plan, x_pad, KC)
    launch(fn, x_pad.device, lr, geom, a, v, items, int(conj_t), int(conj_s), x_pad.data_ptr(),
           k, out.data_ptr())
    pair_bucket_matvec.cuda_launches += 1
    count_launch(pair_bucket_matvec, dtype, k)
    return out


pair_bucket_matvec.launches = 0
pair_bucket_matvec.cuda_launches = 0
pair_bucket_matvec.launches_by_dtype = {}
pair_bucket_matvec.launches_by_k = {}
