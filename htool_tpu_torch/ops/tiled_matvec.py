"""Tiled bucket matvec: host plan, Hopper kernel wrapper, plain version.

Port of ``htool_tpu/ops/tiled_matvec.py`` (``TilePlan``,
``build_tile_plan``, ``tiled_bucket_matvec``).  The plan semantics are the
reference's: a bucket's blocks are sorted by output offset and packed into
output tiles of T rows; a block that runs past its tile's end spills into
the tile's extension zone of E = out_w rows; offsets are tile-relative
(``out_rel``), and ``tile_of``/``first_of`` describe the walk over steps.
The plain version keeps those semantics: it accumulates tiles and folds
them into y, ``y[tT : tT+T+E] += tile_t``.  The kernel reads only
``blk``, ``in_off`` and ``out_off = tile_of·T + out_rel``, and adds each
contribution at that folded row of y directly.

Hopper differences (no VMEM, no sequential grid):

- A tile's blocks are cut into steps of G = 4 slots (the last one padded
  with zero slots, ``blk = -1``), and each step is one CTA.  A tile that
  collects many blocks (at n = 100k, the ~54 blocks that share each of the
  64 partition clusters' rows) is then spread over many SMs instead of
  running on one; a tile with no blocks gets no step.
- T therefore no longer sets the kernel's work per CTA.  It only decides
  where a step is padded (a step never holds blocks of two tiles) and the
  size of the plain version's tile buffers, so it defaults to the
  reference rule's smallest tile, 256 rows, not to a VMEM budget.
- The kernel adds into y with atomics, so the order of the additions,
  and the rounding, varies from run to run.
- The plan indexes the bucket's own arrays through the sort order
  (``blk``) instead of materializing sorted, padded copies; U keeps the
  bucket's ``[nb, bm, r]`` layout (the reference stores it transposed for
  the TPU's (8, 128) tiling).
- No split two-stage plans: with no VMEM gate, every real bucket gets a
  one-shot plan, including wide low-rank buckets.

The kernel is ``htool_tpu_torch/csrc/tiled_matvec.cu``.  The wrapper
launches it for CUDA tensors and runs :func:`tiled_bucket_matvec_reference`
only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

__all__ = [
    "TilePlan",
    "build_tile_plan",
    "tiled_bucket_matvec",
    "tiled_bucket_matvec_reference",
]

_GROUP = 4  # slots per step (one CTA): >= 4 CTAs per SM on every 100k bucket
_TILE_ROWS = 256  # default T (see the module note)
_REF_CHUNK_BYTES = 1 << 28  # block data gathered per pass by the plain version


@dataclass
class TilePlan:
    """Host-planned schedule for one bucket orientation.

    ``data``/``U``/``V`` are the bucket's own tensors (not sorted copies).
    Step i covers slots ``[i·G, (i+1)·G)`` of tile ``tile_of[i]``; slot s
    applies block ``blk[s]`` (-1: padding) to the input window at
    ``in_off[s]`` and adds it at row ``out_off[s] = tile_of[i]·T +
    out_rel[s]`` of y.  The kernel reads ``blk``/``in_off``/``out_off``;
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
    out_w: int
    trans: bool  # apply blocks transposed
    in_end: int  # largest in_off + in_w over the slots (x rows needed)
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

    def astype(self, dtype: torch.dtype) -> "TilePlan":
        """The same schedule over the blocks cast to ``dtype`` (a copy of the
        block data unless it already has that dtype)."""
        if self.kind == "dense":
            return dataclasses.replace(self, data=self.data.to(dtype))
        return dataclasses.replace(self, U=self.U.to(dtype), V=self.V.to(dtype))


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
                    tile_rows: Optional[int] = None) -> TilePlan:
    """Sort the bucket's blocks by their ``out_side`` offsets, pack them into
    output tiles and cut each tile's blocks into steps of G slots (host
    planning over the bucket's offsets)."""
    is_dense = getattr(bucket, "data", None) is not None
    bm, bn = bucket.block_shape
    out_w = bm if out_side == "t" else bn
    in_w = bn if out_side == "t" else bm
    trans = out_side == "s"
    t_off = bucket.t_off.cpu().numpy().astype(np.int64)
    s_off = bucket.s_off.cpu().numpy().astype(np.int64)
    out_off = t_off if out_side == "t" else s_off
    in_off = s_off if out_side == "t" else t_off
    if out_off.size and int(out_off.max()) + out_w > out_len:
        raise ValueError(f"blocks reach row {int(out_off.max()) + out_w}, "
                         f"past out_len {out_len}")

    G = _GROUP
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
    # slot of each sorted block: its tile's first slot + its rank in the tile
    slot = step_start[tile_id] * G + np.arange(order.size) - blk_start[tile_id]
    n_steps = int(steps_of.sum())
    blk = np.full(n_steps * G, -1, np.int64)
    blk[slot] = order
    in_off_p = np.zeros(n_steps * G, np.int64)
    out_rel = np.zeros(n_steps * G, np.int64)
    in_off_p[slot] = in_off[order]
    out_rel[slot] = out_off[order] - tile_id * T
    out_off_p = np.zeros(n_steps * G, np.int64)
    out_off_p[slot] = out_off[order]
    tile_of = np.repeat(np.arange(n_tiles), steps_of)
    first_of = np.zeros(n_steps, np.int64)
    first_of[step_start[counts > 0]] = 1

    dev = (bucket.data if is_dense else bucket.U).device

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    kw = dict(
        T=T, E=out_w, G=G, n_steps=n_steps, n_tiles=n_tiles, out_len=out_len,
        in_w=in_w, out_w=out_w, trans=trans,
        in_end=int(in_off.max()) + in_w if order.size else 0,
        blk=i32(blk), in_off=i32(in_off_p), out_rel=i32(out_rel),
        out_off=i32(out_off_p), tile_of=i32(tile_of), first_of=i32(first_of),
    )
    if is_dense:
        return TilePlan(kind="dense", data=bucket.data, **kw)
    return TilePlan(kind="lr", U=bucket.U, V=bucket.V, **kw)


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


def tiled_bucket_matvec_reference(plan: TilePlan, x_pad: torch.Tensor,
                                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the tiled kernel: gather the input windows
    and blocks of the plan's slots, batched matmul, ``index_add_`` into the
    steps' partial tiles, fold.  Returns y [out_len, k], added into ``out``
    when it is given."""
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
    if plan.kind == "dense":
        per = plan.data[0].numel()
    else:
        per = plan.U[0].numel() + plan.V[0].numel()
    step = max(1, _REF_CHUNK_BYTES // max(1, per * x_pad.element_size()))
    for lo in range(0, b.shape[0], step):
        bc = b[lo : lo + step]
        xg = x_pad[io[lo : lo + step, None] + ar_in]  # [c, in_w, k]
        if plan.kind == "dense":
            D = plan.data[bc].to(x_pad.dtype)
            contrib = (D.transpose(1, 2) if plan.trans else D) @ xg
        else:
            U = plan.U[bc].to(x_pad.dtype)
            V = plan.V[bc].to(x_pad.dtype)
            if plan.trans:
                contrib = V.transpose(1, 2) @ (U.transpose(1, 2) @ xg)
            else:
                contrib = U @ (V @ xg)
        idx = (orow[lo : lo + step, None] + ar_out).reshape(-1)
        parts.index_add_(0, idx, contrib.reshape(-1, k))
    y = _fold(parts.view(plan.n_steps, TE, k), plan)
    return y if out is None else out.add_(y)


def tiled_bucket_matvec(plan: TilePlan, x_pad: torch.Tensor,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run one bucket term: returns y [out_len, k], added into ``out`` (a
    contiguous [out_len, k] tensor) when it is given.

    CUDA tensors launch the Hopper kernel (float32 or float64, same dtype
    as the plan's blocks); CPU tensors run the plain version.  Each launch
    adds one to ``tiled_bucket_matvec.launches``."""
    if x_pad.device.type == "cpu":
        return tiled_bucket_matvec_reference(plan, x_pad, out)
    if x_pad.device.type != "cuda":
        raise ValueError(f"tiled_bucket_matvec: unsupported device {x_pad.device}")
    blocks = [plan.data] if plan.kind == "dense" else [plan.U, plan.V]
    ints = [plan.blk, plan.in_off, plan.out_off]
    dtype = x_pad.dtype
    k = int(x_pad.shape[1]) if x_pad.ndim == 2 else 0
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tiled_bucket_matvec: kernel takes float32/float64, got {dtype}")
    if x_pad.ndim != 2 or not x_pad.is_contiguous():
        raise ValueError("tiled_bucket_matvec: x_pad must be a contiguous [L, k] tensor")
    if out is None:
        out = torch.zeros((plan.out_len, k), dtype=dtype, device=x_pad.device)
    elif tuple(out.shape) != (plan.out_len, k) or out.dtype != dtype or not out.is_contiguous():
        raise ValueError(f"tiled_bucket_matvec: out must be a contiguous {dtype} "
                         f"[{plan.out_len}, {k}] tensor")
    for t in blocks + ints + [out]:
        if t.device != x_pad.device or not t.is_contiguous():
            raise ValueError("tiled_bucket_matvec: plan tensors must be contiguous "
                             f"and on {x_pad.device}")
    if any(t.dtype != dtype for t in blocks):
        raise TypeError(f"tiled_bucket_matvec: blocks are {blocks[0].dtype}, x is {dtype}")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("tiled_bucket_matvec: plan indices must be int32")
    if x_pad.shape[0] < plan.in_end:
        raise ValueError(f"tiled_bucket_matvec: x_pad has {x_pad.shape[0]} rows, "
                         f"the plan reads {plan.in_end}")
    from ..kernels import check, load_library

    lib = load_library()
    if plan.kind == "dense":
        bm, bn = plan.data.shape[1], plan.data.shape[2]
        r = 0
        ptrs = (plan.data.data_ptr(), None, None)
    else:
        bm, r, bn = plan.U.shape[1], plan.U.shape[2], plan.V.shape[2]
        ptrs = (None, plan.U.data_ptr(), plan.V.data_ptr())
    fn = lib.htool_tiled_matvec_f32 if dtype == torch.float32 else lib.htool_tiled_matvec_f64
    with torch.cuda.device(x_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(
            0 if plan.kind == "dense" else 1, int(plan.trans), *ptrs,
            int(bm), int(bn), int(r),
            plan.blk.data_ptr(), plan.in_off.data_ptr(), plan.out_off.data_ptr(),
            int(plan.n_steps), int(plan.G),
            x_pad.data_ptr(), k, out.data_ptr(), ctypes.c_void_p(stream),
        )
    check(code)
    tiled_bucket_matvec.launches += 1
    return out


tiled_bucket_matvec.launches = 0
