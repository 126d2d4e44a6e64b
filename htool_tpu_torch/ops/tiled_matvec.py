"""Tiled bucket matvec: host plans, Hopper kernel wrapper, plain version.

Port of ``htool_tpu/ops/tiled_matvec.py`` (``TilePlan``,
``build_tile_plan``, ``build_tile_plan_lr_split`` + ``_chunk_stand_width``,
``build_tile_plan_complex``, ``tiled_bucket_matvec``).
The plan semantics are the reference's: a bucket's blocks are sorted by
output offset and packed into output tiles of T rows; a block that runs
past its tile's end spills into
the tile's extension zone of E = out_w rows; offsets are tile-relative
(``out_rel``), and ``tile_of``/``first_of`` describe the walk over steps.
The plain version keeps those semantics: it accumulates tiles and folds
them into y, ``y[tT : tT+T+E] += tile_t``.  The kernels read only
``blk``, ``in_off`` and ``out_off = tile_of·T + out_rel``, and add each
contribution at that folded row of y directly.

Hopper differences (no VMEM, no sequential grid):

- Work is cut by bytes (:mod:`.cut`), not by blocks: a plan entry (slot) is
  one *panel* of a block, ``blk = b·P + p``: block b cut into P panels of
  ``cut`` output rows (P = 1 for small blocks), and a step (one CTA) holds G
  slots, with G chosen so that a CTA streams about 128 KB.  A tile that
  collects many blocks (at n = 100k, the ~54 blocks that share each of the
  64 partition clusters' rows) is spread over many SMs; a tile with no
  blocks gets no step.
- T therefore does not set the kernel's work per CTA.  It only decides
  where a step is padded (a step never holds panels of two tiles) and the
  size of the plain version's tile buffers, so it defaults to the
  reference rule's smallest tile, 256 rows, not to a VMEM budget.
- The kernels add into y with atomics, so the order of the additions,
  and the rounding, varies from run to run.
- The plan indexes the bucket's own arrays through the sort order
  (``blk``) instead of materializing sorted, padded copies; U keeps the
  bucket's ``[nb, bm, r]`` layout (the reference stores it transposed for
  the TPU's (8, 128) tiling).
- Split two-stage plans (:func:`build_tile_plan_lr_split`) exist for speed,
  not for a memory gate: stage A writes ``t = op(V)·x`` (or ``op(U)ᵀ·x``)
  into a staging tensor ``[nb·r_pad, k]`` in device memory, stage B adds
  ``op(U)·t`` into y.  Both stages are dense plans over the bucket's own U
  and V (no transposed or padded copies), each cut by the byte rule, so one
  wide block spreads over many CTAs in both stages.  Stage B's output
  chunks (the reference's ``_chunk_stand_width``, at most 2048 wide) are
  the rule's panels: the last one is clipped, never padded.
  :func:`..hmatrix.linalg.prepare_tiled_matvec` picks the one-launch or
  the split plan per bucket by :func:`.cut.lr_split_wanted`.
- Complex buckets need no plane plans.  The reference splits a complex64
  bucket into real and imaginary planes (``ComplexPlans``,
  ``apply_complex_plans``: 2 launches per dense term, 4 per low-rank term,
  a ``sigma`` sign for the conjugated modes, a VMEM gate
  ``complex_plans_ok``) because its kernel has no complex type.  The CUDA
  kernels have one, so :func:`build_tile_plan_complex` is an ordinary plan
  over the bucket's complex tensors, of either width, and
  ``tiled_bucket_matvec(..., conj=True)`` gives the conjugated modes.

The kernels are ``htool_tpu_torch/csrc/stream_matvec.cu`` (dense plans and
both stages of a split plan: panels streamed through shared memory) and
``csrc/tiled_matvec.cu`` (one-launch low-rank plans, t in shared memory:
terms too short for a second launch to pay).
The wrapper launches them for CUDA tensors and runs
:func:`tiled_bucket_matvec_reference` only for CPU tensors.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .cut import cut_rule, panels, staging_rows

__all__ = [
    "TilePlan",
    "SplitPlan",
    "build_tile_plan",
    "build_tile_plan_lr_split",
    "build_tile_plan_complex",
    "tiled_bucket_matvec",
    "tiled_bucket_matvec_reference",
]

_GROUP_LR = 4  # slots per step of a one-launch low-rank plan
_TILE_ROWS = 256  # default T (see the module note)
_REF_CHUNK_BYTES = 1 << 28  # block data gathered per pass by the plain version
_STAGE_B_CHUNK = 2048  # widest output chunk of a stage-B plan entry


@dataclass
class TilePlan:
    """Host-planned schedule for one bucket orientation.

    ``data``/``U``/``V`` are the bucket's own tensors (not sorted copies).
    Step i covers slots ``[i·G, (i+1)·G)`` of tile ``tile_of[i]``; slot s
    applies panel ``blk[s] % P`` of block ``blk[s] // P`` (-1: padding) to
    the input window at ``in_off[s]`` and adds it at row ``out_off[s] =
    tile_of[i]·T + out_rel[s]`` of y.  Panel p is output rows ``[p·cut,
    min((p+1)·cut, width))`` of the block's output window; with P = 1 a
    slot is a whole block.  The kernels read ``blk``/``in_off``/``out_off``;
    the plain version reads ``out_rel``/``tile_of`` and folds; ``first_of``
    is the reference plan's walk, kept for comparing plans."""

    kind: str  # "dense" | "lr"
    T: int  # tile rows
    E: int  # extension rows (= out_w)
    G: int  # slots per step
    n_steps: int
    n_tiles: int
    out_len: int
    in_w: int
    out_w: int  # output rows of a slot (= cut)
    trans: bool  # apply blocks transposed
    in_end: int  # largest in_off + in_w over the slots (x rows needed)
    P: int = 1  # panels per block
    data: Optional[torch.Tensor] = None  # [nb, bm, bn] (dense)
    U: Optional[torch.Tensor] = None  # [nb, bm, r] (lr)
    V: Optional[torch.Tensor] = None  # [nb, r, bn] (lr)
    blk: Optional[torch.Tensor] = None  # [n_steps*G] int32
    in_off: Optional[torch.Tensor] = None  # [n_steps*G] int32
    out_rel: Optional[torch.Tensor] = None  # [n_steps*G] int32
    out_off: Optional[torch.Tensor] = None  # [n_steps*G] int32 (tile_of·T + out_rel)
    tile_of: Optional[torch.Tensor] = None  # [n_steps] int32
    first_of: Optional[torch.Tensor] = None  # [n_steps] int32 (1 = first step of its tile)

    @property
    def dtype(self) -> torch.dtype:
        return (self.data if self.kind == "dense" else self.U).dtype

    @property
    def cut(self) -> int:
        return self.out_w

    def astype(self, dtype: torch.dtype) -> "TilePlan":
        """The same schedule over the blocks cast to ``dtype`` (a copy of the
        block data unless it already has that dtype)."""
        if self.kind == "dense":
            return dataclasses.replace(self, data=self.data.to(dtype))
        return dataclasses.replace(self, U=self.U.to(dtype), V=self.V.to(dtype))


@dataclass
class SplitPlan:
    """Two chained dense plans for one low-rank bucket orientation: stage A
    writes ``t = op(V)·x`` (``op(U)ᵀ·x`` when transposed) at rows ``b·r_pad``
    of a staging tensor ``[t_len, k]``, stage B adds ``op(U)·t`` (``op(V)ᵀ·t``)
    into y.  Unpacks as ``planA, planB``."""

    stage_a: TilePlan
    stage_b: TilePlan
    r_pad: int  # rows of t per block

    kind = "lr_split"

    def __iter__(self):
        return iter((self.stage_a, self.stage_b))

    @property
    def t_len(self) -> int:
        return self.stage_a.out_len

    @property
    def out_len(self) -> int:
        return self.stage_b.out_len

    @property
    def in_end(self) -> int:
        return self.stage_a.in_end

    @property
    def trans(self) -> bool:
        return self.stage_a.trans

    @property
    def dtype(self) -> torch.dtype:
        return self.stage_a.dtype

    def astype(self, dtype: torch.dtype) -> "SplitPlan":
        return SplitPlan(self.stage_a.astype(dtype), self.stage_b.astype(dtype), self.r_pad)


def _tile_rows(out_len: int, tile_rows: Optional[int]) -> int:
    """Tile height, by the reference's rule: the smallest power of two
    >= 256 that reaches ``min(tile_rows, out_len)``, so plans compare tile
    by tile.  ``tile_rows`` defaults to 256."""
    if tile_rows is None:
        tile_rows = _TILE_ROWS
    T = 256
    while T < min(int(tile_rows), out_len):
        T *= 2
    return T


def build_tile_plan(bucket, out_side: str, out_len: int,
                    tile_rows: Optional[int] = None, max_cut: Optional[int] = None) -> TilePlan:
    """Sort the bucket's blocks by their ``out_side`` offsets, cut them into
    panels by the byte rule (dense buckets; ``max_cut`` bounds a panel's
    output rows), pack the panels into output tiles and cut each tile's
    panels into steps of G slots (host planning over the bucket's offsets)."""
    is_dense = getattr(bucket, "data", None) is not None
    bm, bn = bucket.block_shape
    blocks = bucket.data if is_dense else bucket.U
    ext = bm if out_side == "t" else bn  # output rows of a block
    in_w = bn if out_side == "t" else bm
    trans = out_side == "s"
    t_off = torch.as_tensor(bucket.t_off).cpu().numpy().astype(np.int64)
    s_off = torch.as_tensor(bucket.s_off).cpu().numpy().astype(np.int64)
    nb = t_off.shape[0]
    if is_dense:
        P, cut, G = cut_rule(nb, bm, bn, blocks.element_size(), trans)
        if max_cut is not None and cut > max_cut:
            P = -(-ext // max_cut)
            cut = -(-ext // P)
            P = -(-ext // cut)
    else:  # the one-launch low-rank kernel takes whole blocks
        P, cut, G = 1, ext, _GROUP_LR
    lo = np.array([a for a, _ in panels(ext, P, cut)], np.int64)
    # one entry per panel, block-major: value b·P + p
    slot_val = np.arange(nb * P, dtype=np.int64)
    blk_out, blk_in = (t_off, s_off) if out_side == "t" else (s_off, t_off)
    if nb and int(blk_out.max()) + ext > out_len:
        raise ValueError(f"blocks reach row {int(blk_out.max()) + ext}, past out_len {out_len}")
    out_off = np.repeat(blk_out, P) + np.tile(lo, nb)
    in_off = np.repeat(blk_in, P)

    T = _tile_rows(out_len, tile_rows)
    n_tiles = max(1, -(-out_len // T))
    order = np.argsort(out_off, kind="stable")
    tile_id = np.minimum(out_off[order] // T, n_tiles - 1)
    counts = np.bincount(tile_id, minlength=n_tiles)
    steps_of = -(-counts // G)  # a tile with no blocks gets no step
    step_start = np.zeros(n_tiles, np.int64)
    np.cumsum(steps_of[:-1], out=step_start[1:])
    blk_start = np.zeros(n_tiles, np.int64)
    np.cumsum(counts[:-1], out=blk_start[1:])
    # slot of each sorted panel: its tile's first slot + its rank in the tile
    slot = step_start[tile_id] * G + np.arange(order.size) - blk_start[tile_id]
    n_steps = int(steps_of.sum())
    blk = np.full(n_steps * G, -1, np.int64)
    blk[slot] = slot_val[order]
    in_off_p = np.zeros(n_steps * G, np.int64)
    out_rel = np.zeros(n_steps * G, np.int64)
    in_off_p[slot] = in_off[order]
    out_rel[slot] = out_off[order] - tile_id * T
    out_off_p = np.zeros(n_steps * G, np.int64)
    out_off_p[slot] = out_off[order]
    tile_of = np.repeat(np.arange(n_tiles), steps_of)
    first_of = np.zeros(n_steps, np.int64)
    first_of[step_start[counts > 0]] = 1

    dev = blocks.device

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    kw = dict(
        T=T, E=cut, G=G, P=P, n_steps=n_steps, n_tiles=n_tiles, out_len=out_len,
        in_w=in_w, out_w=cut, trans=trans,
        in_end=int(in_off.max()) + in_w if order.size else 0,
        blk=i32(blk), in_off=i32(in_off_p), out_rel=i32(out_rel),
        out_off=i32(out_off_p), tile_of=i32(tile_of), first_of=i32(first_of),
    )
    if is_dense:
        return TilePlan(kind="dense", data=bucket.data, **kw)
    return TilePlan(kind="lr", U=bucket.U, V=bucket.V, **kw)


class _DenseStand:
    """Minimal dense-bucket stand-in for build_tile_plan: one factor of a
    low-rank bucket with the offsets of one stage."""

    def __init__(self, data, t_off, s_off):
        self.data = data
        self.t_off = t_off
        self.s_off = s_off

    @property
    def block_shape(self):
        return (int(self.data.shape[1]), int(self.data.shape[2]))


def _chunk_stand_width(W: int, chunk: int = _STAGE_B_CHUNK):
    """Output chunks ``[lo, hi)`` of a stage-B factor of width ``W``, at most
    ``chunk`` wide.  The reference pads W to whole chunks and relies on the
    padded tail being zero; here the tail chunk is clipped to W and the
    cover is asserted."""
    n_ch = -(-W // chunk)
    width = -(-W // n_ch)
    return panels(W, -(-W // width), width)


def build_tile_plan_lr_split(bucket, out_side: str, out_len: int,
                             tile_rows: Optional[int] = None) -> SplitPlan:
    """Two chained dense plans for a low-rank bucket: stage A computes
    ``t_i = op(V)_i · x_i`` into a compact ``[nb·r_pad]`` staging vector
    (blocks write disjoint rows ``i·r_pad``), stage B accumulates ``y +=
    op(U)_i · t_i`` with the normal output tiling (transposed: U first, then
    V).  Both index the bucket's own U and V."""
    if getattr(bucket, "U", None) is None:
        raise TypeError("build_tile_plan_lr_split takes a low-rank bucket")
    nb, bm, r = (int(s) for s in bucket.U.shape)
    bn = int(bucket.V.shape[2])
    r_pad = staging_rows(r)
    mid_off = torch.arange(nb, dtype=torch.int64) * r_pad
    if out_side == "t":
        # t = V x (V as stored), y += U t (U as stored)
        stage_a = _DenseStand(bucket.V, t_off=mid_off, s_off=bucket.s_off)
        stage_b = _DenseStand(bucket.U, t_off=bucket.t_off, s_off=mid_off)
        width = bm
    else:
        # t = Uᵀ x, y += Vᵀ t (both applied transposed)
        stage_a = _DenseStand(bucket.U, t_off=bucket.t_off, s_off=mid_off)
        stage_b = _DenseStand(bucket.V, t_off=mid_off, s_off=bucket.s_off)
        width = bn
    widest = max(hi - lo for lo, hi in _chunk_stand_width(width))
    plan_a = build_tile_plan(stage_a, out_side, nb * r_pad, tile_rows)
    plan_b = build_tile_plan(stage_b, out_side, out_len, tile_rows, max_cut=widest)
    # stage A stores: every row of t that stage B reads is written by exactly one slot
    assert plan_a.P * plan_a.out_w >= r and plan_b.in_w == r
    return SplitPlan(plan_a, plan_b, r_pad)


def build_tile_plan_complex(bucket, out_side: str, out_len: int,
                            tile_rows: Optional[int] = None):
    """Plan for a complex bucket (complex64 or complex128): the counterpart
    of the reference's ``build_tile_plan_complex``.  There a complex bucket
    becomes real plans over its real and imaginary planes; here the kernels
    read interleaved complex entries, so the plan is :func:`build_tile_plan`'s
    over the bucket's own complex tensors and no plane copy exists.  The
    conjugated modes are ``tiled_bucket_matvec(plan, x, conj=True)``."""
    blocks = bucket.data if getattr(bucket, "data", None) is not None else bucket.U
    if not blocks.dtype.is_complex:
        raise TypeError(f"build_tile_plan_complex: the bucket is {blocks.dtype}")
    return build_tile_plan(bucket, out_side, out_len, tile_rows)


def _fold(parts: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """y[t·T : t·T + T + E] += parts[i] for every step i of tile t, as
    ceil((T+E)/T) adds of T-row slabs."""
    n_steps, TE, k = parts.shape
    T = plan.T
    Q = -(-TE // T)
    parts = torch.nn.functional.pad(parts, (0, 0, 0, Q * T - TE)).view(n_steps, Q, T, k)
    y = torch.zeros((plan.n_tiles + Q - 1, T, k), dtype=parts.dtype, device=parts.device)
    tile_of = plan.tile_of.to(parts.device).long()
    for q in range(Q):
        y.index_add_(0, tile_of + q, parts[:, q])
    return y.view(-1, k)[: plan.out_len]


def _plain_dense(plan: TilePlan, x_pad: torch.Tensor, conj: bool) -> torch.Tensor:
    """parts [n_steps*(T+E), k] of a dense plan: per panel index, gather the
    input windows and the panels' rows of op(D), batched matmul,
    ``index_add_`` into the steps' partial tiles."""
    k = x_pad.shape[1]
    dev = x_pad.device
    TE = plan.T + plan.E
    parts = torch.zeros((plan.n_steps * TE, k), dtype=x_pad.dtype, device=dev)
    blk = plan.blk.to(dev).long()
    ar_in = torch.arange(plan.in_w, device=dev)
    bm, bn = plan.data.shape[1], plan.data.shape[2]
    ext = bn if plan.trans else bm
    for p, (lo, hi) in enumerate(panels(ext, plan.P, plan.out_w)):
        sel = torch.nonzero((blk >= 0) & (blk % plan.P == p)).flatten()
        b = blk[sel] // plan.P
        io = plan.in_off.to(dev).long()[sel]
        orow = (sel // plan.G) * TE + plan.out_rel.to(dev).long()[sel]
        ar_out = torch.arange(hi - lo, device=dev)
        per = (hi - lo) * plan.in_w
        step = max(1, _REF_CHUNK_BYTES // max(1, per * x_pad.element_size()))
        for c0 in range(0, b.shape[0], step):
            bc = b[c0 : c0 + step]
            xg = x_pad[io[c0 : c0 + step, None] + ar_in]  # [c, in_w, k]
            D = plan.data[bc, :, lo:hi] if plan.trans else plan.data[bc, lo:hi]
            D = D.to(x_pad.dtype)
            if conj:
                D = D.conj()
            contrib = (D.transpose(1, 2) if plan.trans else D) @ xg
            idx = (orow[c0 : c0 + step, None] + ar_out).reshape(-1)
            parts.index_add_(0, idx, contrib.reshape(-1, k))
    return parts


def _plain_lr(plan: TilePlan, x_pad: torch.Tensor, conj: bool) -> torch.Tensor:
    """parts of a one-launch low-rank plan: ``U (V x)`` or ``Vᵀ (Uᵀ x)`` on
    gathered windows."""
    k = x_pad.shape[1]
    dev = x_pad.device
    TE = plan.T + plan.E
    parts = torch.zeros((plan.n_steps * TE, k), dtype=x_pad.dtype, device=dev)
    blk = plan.blk.to(dev).long()
    sel = torch.nonzero(blk >= 0).flatten()
    b = blk[sel]
    io = plan.in_off.to(dev).long()[sel]
    orow = (sel // plan.G) * TE + plan.out_rel.to(dev).long()[sel]
    ar_in = torch.arange(plan.in_w, device=dev)
    ar_out = torch.arange(plan.out_w, device=dev)
    per = plan.U[0].numel() + plan.V[0].numel()
    step = max(1, _REF_CHUNK_BYTES // max(1, per * x_pad.element_size()))
    for lo in range(0, b.shape[0], step):
        bc = b[lo : lo + step]
        xg = x_pad[io[lo : lo + step, None] + ar_in]  # [c, in_w, k]
        U = plan.U[bc].to(x_pad.dtype)
        V = plan.V[bc].to(x_pad.dtype)
        if conj:
            U, V = U.conj(), V.conj()
        if plan.trans:
            contrib = V.transpose(1, 2) @ (U.transpose(1, 2) @ xg)
        else:
            contrib = U @ (V @ xg)
        idx = (orow[lo : lo + step, None] + ar_out).reshape(-1)
        parts.index_add_(0, idx, contrib.reshape(-1, k))
    return parts


def tiled_bucket_matvec_reference(plan, x_pad: torch.Tensor,
                                  out: Optional[torch.Tensor] = None,
                                  conj: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the tiled kernels: gather the input windows
    and blocks (or panels) of the plan's slots, batched matmul,
    ``index_add_`` into the steps' partial tiles, fold.  A
    :class:`SplitPlan` runs its two stages one after the other through the
    staging tensor t.  ``conj`` applies the conjugated blocks.
    Returns y [out_len, k], added into ``out`` when it is given."""
    if isinstance(plan, SplitPlan):
        t = tiled_bucket_matvec_reference(plan.stage_a, x_pad, conj=conj)
        return tiled_bucket_matvec_reference(plan.stage_b, t, out, conj)
    parts = (_plain_dense if plan.kind == "dense" else _plain_lr)(plan, x_pad, conj)
    y = _fold(parts.view(plan.n_steps, plan.T + plan.E, x_pad.shape[1]), plan)
    return y if out is None else out.add_(y)


def _launch_args(plan: TilePlan, device, dtype):
    """Validate a plan's tensors once and cache the constant arguments of its
    kernel call (everything but x, k, y and the stream)."""
    cached = getattr(plan, "_args", None)
    if cached is not None and cached[0] == (device, dtype):
        return cached[1]
    blocks = [plan.data] if plan.kind == "dense" else [plan.U, plan.V]
    ints = [plan.blk, plan.in_off, plan.out_off]
    for t in blocks + ints:
        if t.device != device or not t.is_contiguous():
            raise ValueError("tiled_bucket_matvec: plan tensors must be contiguous "
                             f"and on {device}")
    if any(t.dtype != dtype for t in blocks):
        raise TypeError(f"tiled_bucket_matvec: blocks are {blocks[0].dtype}, x is {dtype}")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("tiled_bucket_matvec: plan indices must be int32")
    from ..kernels import entry_point

    ptrs = (plan.blk.data_ptr(), plan.in_off.data_ptr(), plan.out_off.data_ptr())
    if plan.kind == "dense":
        # CTA c takes the slots [c·G, (c+1)·G) of the flat list: the plan's steps
        nb, R, C = (int(s) for s in plan.data.shape)
        fn = entry_point("htool_stream_matvec", dtype)
        head = (int(plan.trans),)
        mid = (plan.data.data_ptr(), R, C, int(plan.P), int(plan.out_w), *ptrs,
               int(plan.n_steps) * int(plan.G), int(plan.G))
    else:
        bm, r, bn = plan.U.shape[1], plan.U.shape[2], plan.V.shape[2]
        fn = entry_point("htool_tiled_matvec", dtype)
        head = (int(plan.trans),)
        mid = (plan.U.data_ptr(), plan.V.data_ptr(), int(bm), int(bn), int(r), *ptrs,
               int(plan.n_steps), int(plan.G))
    plan._args = ((device, dtype), (fn, head, mid))
    return plan._args[1]


def _launch(plan: TilePlan, x_pad: torch.Tensor, out: torch.Tensor, conj: bool,
            store: bool) -> None:
    from ..kernels import launch

    fn, head, mid = _launch_args(plan, x_pad.device, x_pad.dtype)
    if x_pad.shape[0] < plan.in_end:
        raise ValueError(f"tiled_bucket_matvec: x_pad has {x_pad.shape[0]} rows, "
                         f"the plan reads {plan.in_end}")
    flags = (int(conj), int(store)) if plan.kind == "dense" else (int(conj),)
    launch(fn, x_pad.device, *head, *flags, *mid, x_pad.data_ptr(), int(x_pad.shape[1]),
           out.data_ptr())
    tiled_bucket_matvec.cuda_launches += 1


def tiled_bucket_matvec(plan, x_pad: torch.Tensor,
                        out: Optional[torch.Tensor] = None,
                        conj: bool = False) -> torch.Tensor:
    """Run one bucket term: returns y [out_len, k], added into ``out`` (a
    contiguous [out_len, k] tensor) when it is given.  ``plan`` is a
    :class:`TilePlan` or a :class:`SplitPlan`; ``conj`` applies the
    conjugated blocks (with the plan's ``trans``: Bᴴ).

    CUDA tensors launch the Hopper kernels (float32, float64, complex64 or
    complex128, same dtype as the plan's blocks); CPU tensors run the plain
    version.  Each term that goes to the GPU adds one to
    ``tiled_bucket_matvec.launches`` and to
    ``tiled_bucket_matvec.launches_by_dtype[dtype]``; the CUDA launches it
    makes (two for a split plan) add to ``tiled_bucket_matvec.cuda_launches``."""
    if x_pad.device.type == "cpu":
        return tiled_bucket_matvec_reference(plan, x_pad, out, conj)
    if x_pad.device.type != "cuda":
        raise ValueError(f"tiled_bucket_matvec: unsupported device {x_pad.device}")
    dtype = x_pad.dtype
    k = int(x_pad.shape[1]) if x_pad.ndim == 2 else 0
    if x_pad.ndim != 2 or not x_pad.is_contiguous():
        raise ValueError("tiled_bucket_matvec: x_pad must be a contiguous [L, k] tensor")
    if out is None:
        out = torch.zeros((plan.out_len, k), dtype=dtype, device=x_pad.device)
    elif (tuple(out.shape) != (plan.out_len, k) or out.dtype != dtype
          or out.device != x_pad.device or not out.is_contiguous()):
        raise ValueError(f"tiled_bucket_matvec: out must be a contiguous {dtype} "
                         f"[{plan.out_len}, {k}] tensor on {x_pad.device}")
    from ..kernels import count_launch

    if isinstance(plan, SplitPlan):
        t = torch.empty((plan.t_len, k), dtype=dtype, device=x_pad.device)
        _launch(plan.stage_a, x_pad, t, conj, True)
        _launch(plan.stage_b, t, out, conj, False)
    else:
        _launch(plan, x_pad, out, conj, False)
    count_launch(tiled_bucket_matvec, dtype, k)
    return out


tiled_bucket_matvec.launches = 0
tiled_bucket_matvec.cuda_launches = 0
tiled_bucket_matvec.launches_by_dtype = {}
tiled_bucket_matvec.launches_by_k = {}
