"""How the product kernels cut a bucket's work: one rule per bucket, by bytes.

All blocks of a bucket have one shape, so the cut is computed once, on the
host, from the shape alone.  A *matrix* here is what one kernel launch
streams per block: a dense block ``[bm, bn]``, or one factor of a low-rank
block (``V [r, bn]`` and ``U [bm, r]``, one per stage).  The kernel applies
it as stored (``trans=False``: out rows are the matrix's rows) or transposed
(``trans=True``: out rows are its columns).

The rule cuts along the OUTPUT dimension only, so no two CTAs hold partial
sums of one output entry: a matrix is cut into ``P`` panels of ``cut``
output rows (row panels of the stored matrix, contiguous in memory, or
column slabs of it when transposed), the last one clipped; panels smaller
than the byte target are grouped ``G`` to a CTA.  Every CTA then streams
about ``target`` bytes, and a bucket of few large blocks still fills the
card's 132 SMs.

``_TARGET_BYTES`` was chosen by timing on an NVIDIA H100 80GB HBM3
(``tools/torch_kernel_probe.py``; the sweep is in PERF.md section 6).
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["Cut", "cut_rule", "panels", "lr_stage_shapes", "staging_rows"]

_TARGET_BYTES = 256 * 1024  # bytes one CTA should stream
_MIN_BYTES = 16 * 1024  # never cut finer than this
_SMS = 132  # streaming multiprocessors of an H100
_FILL_CTAS = 4 * _SMS  # CTAs wanted per launch when the bucket is large enough
_GROUP_MAX = 32  # slots per CTA at most
_SLAB_MAX = 256  # columns of a transposed slab at most (threads per CTA)
_SLAB_MIN_BYTES = 64  # bytes of a slab's row segment at least
_ROW_GROUP = 16  # rows the kernel holds sums for while it walks a wide row


class Cut(NamedTuple):
    P: int  # panels per block along the output dimension
    cut: int  # output rows per panel (the last panel is clipped)
    G: int  # panels per CTA


def panels(ext: int, P: int, cut: int):
    """The ``P`` ranges ``[lo, hi)`` that cover ``[0, ext)``: panel p is
    ``[p·cut, min(ext, (p+1)·cut))``.  Asserts that they tile the extent
    exactly (no padded tail)."""
    out = [(p * cut, min(ext, (p + 1) * cut)) for p in range(P)]
    assert out and out[0][0] == 0 and out[-1][1] == ext and all(lo < hi for lo, hi in out), (
        f"cut {cut} x {P} panels does not tile {ext}")
    return out


def cut_rule(nb: int, R: int, C: int, itemsize: int, trans: bool,
             live_share: float = 1.0) -> Cut:
    """The cut of a bucket of ``nb`` row-major matrices ``[R, C]`` applied as
    stored or transposed.  ``live_share`` (0 < share <= 1) is the share of
    the stored bytes that a launch streams: a planned launch reads each
    block at its live extent (its true rows, columns and rank), so the
    byte targets are met in the bytes it reads, not in the padded ones."""
    ext = C if trans else R  # output dimension
    line = max(1, int((R if trans else C) * itemsize * live_share))  # bytes read per output row
    total = max(1, nb) * ext * line
    tgt = max(_MIN_BYTES, min(_TARGET_BYTES, total // _FILL_CTAS))
    cut = max(1, tgt // line)
    if trans:
        align = max(1, 16 // itemsize)  # slabs start on 16-byte boundaries
        floor = max(align, _SLAB_MIN_BYTES // itemsize)
        cut = min(_SLAB_MAX, max(floor, cut // align * align))
    elif C * itemsize > 1024 and max(1, nb) * -(-ext // max(cut, _ROW_GROUP)) >= _SMS:
        # a wide row is walked in chunks with the sums of one row group in
        # registers: whole row groups, unless that leaves SMs without work
        cut = max(cut, _ROW_GROUP)
    if cut >= ext or (ext * line <= 2 * tgt and (not trans or ext <= _SLAB_MAX)):
        # whole blocks up to twice the target: a second panel would stage x again
        P, cut = 1, ext
    else:
        P = -(-ext // cut)
        cut = -(-ext // P)  # even the panels out
        if trans:
            cut = min(_SLAB_MAX, -(-cut // align) * align)
        P = -(-ext // cut)
    G = max(1, min(_GROUP_MAX, tgt // max(1, cut * line)))
    return Cut(P, cut, G)


def staging_rows(r: int) -> int:
    """Rows of the staging tensor t per block of rank ``r``: ``r`` rounded up
    to a multiple of 8 (at least 8), as the reference's split plan pads it."""
    return max(8, -(-r // 8) * 8)


def lr_stage_shapes(bm: int, bn: int, r: int, trans: bool):
    """((R, C) of stage A's matrix, (R, C) of stage B's) for a low-rank block
    ``U [bm, r] · V [r, bn]``: ``t = V x`` then ``y += U t``, or transposed
    ``t = Uᵀ x`` then ``y += Vᵀ t``.  Each stage applies its matrix with the
    term's ``trans``."""
    return ((bm, r), (r, bn)) if trans else ((r, bn), (bm, r))
