"""Storage padding of an H-matrix made visible: a copy whose padded entries
hold a chosen value.

Buckets store every block at one padded shape and one padded rank, with
exact zeros past each block's true rows, columns and rank.  A product that
reads only the live extent gives the same answer whatever the padding
holds; :func:`fill_padding` with NaN shows whether it does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..hmatrix.hmatrix import HMatrix

__all__ = ["fill_padding"]


def _outside(n: int, live, device) -> torch.Tensor:
    """[nb, n] bool: index i of block b lies at or past live[b]."""
    live = torch.as_tensor(np.asarray(live, np.int64), device=device)
    return torch.arange(n, device=device)[None, :] >= live[:, None]


def fill_padding(h: HMatrix, value: float) -> HMatrix:
    """A copy of ``h`` (new block tensors, no plans) whose stored entries
    outside each block's live extent hold ``value``: rows and columns of a
    dense block past its true sizes; rows of U and columns of V past the
    block's true sizes, and columns of U and rows of V past its true rank."""
    dense, lr = [], []
    for b in h.dense_buckets:
        _, bm, bn = b.data.shape
        out = (_outside(bm, b.t_sizes, b.data.device)[:, :, None]
               | _outside(bn, b.s_sizes, b.data.device)[:, None, :])
        dense.append(dataclasses.replace(b, data=b.data.masked_fill(out, value),
                                         plan_t=None, plan_s=None, pair=None))
    for b in h.lr_buckets:
        _, bm, r = b.U.shape
        bn = b.V.shape[2]
        dev = b.U.device
        rank = _outside(r, b.ranks, dev)
        U = b.U.masked_fill(_outside(bm, b.t_sizes, dev)[:, :, None] | rank[:, None, :], value)
        V = b.V.masked_fill(rank[:, :, None] | _outside(bn, b.s_sizes, dev)[:, None, :], value)
        lr.append(dataclasses.replace(b, U=U, V=V, plan_t=None, plan_s=None, pair=None))
    return dataclasses.replace(h, dense_buckets=dense, lr_buckets=lr, info=dict(h.info))
