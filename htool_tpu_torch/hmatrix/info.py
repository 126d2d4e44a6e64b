"""H-matrix structure metrics — compression ratio, space saving, rank stats.

A copy of ``htool_tpu/hmatrix/info.py`` (NumPy only).

Mirrors ``get_hmatrix_information`` (``hmatrix/hmatrix_output.hpp:134-216``):
- compression ratio = (nr·nc) / Σ generated coefficients, where a dense leaf
  generates M·N and a low-rank leaf r·(M+N) (hmatrix_output.hpp:154-175,204)
- space saving = 1 − generated/(nr·nc) (hmatrix_output.hpp:205)
- block counts and leaf-rank min/mean/max (hmatrix_output.hpp:143-203)

Counts use TRUE (unpadded) block sizes and true ACA ranks, so numbers are
directly comparable with the C++ reference.
"""

from __future__ import annotations

import numpy as np

from .hmatrix import HMatrix

__all__ = ["hmatrix_info", "print_hmatrix_information"]


def hmatrix_info(h: HMatrix) -> dict:
    m_loc, n_glob = h.shape
    total = float(m_loc) * float(n_glob)

    dense_coeffs = 0.0
    dense_sizes = []
    for b in h.dense_buckets:
        t = np.asarray(b.t_sizes, dtype=np.float64)
        s = np.asarray(b.s_sizes, dtype=np.float64)
        dense_coeffs += float(np.sum(t * s))
        dense_sizes.extend((t * s).tolist())

    lr_coeffs = 0.0
    ranks = []
    for b in h.lr_buckets:
        t = np.asarray(b.t_sizes, dtype=np.float64)
        s = np.asarray(b.s_sizes, dtype=np.float64)
        r = np.asarray(b.ranks, dtype=np.float64)
        lr_coeffs += float(np.sum(r * (t + s)))
        ranks.extend(np.asarray(b.ranks).tolist())

    generated = dense_coeffs + lr_coeffs
    info = dict(h.info)
    info.update(
        target_size=m_loc,
        source_size=n_glob,
        n_dense_blocks=sum(b.n_blocks for b in h.dense_buckets),
        n_low_rank_blocks=sum(b.n_blocks for b in h.lr_buckets),
        compression_ratio=(total / generated) if generated else float("inf"),
        space_saving=1.0 - generated / total if total else 0.0,
        rank_min=int(min(ranks)) if ranks else 0,
        rank_max=int(max(ranks)) if ranks else 0,
        rank_mean=float(np.mean(ranks)) if ranks else 0.0,
        dense_block_size_min=int(min(dense_sizes)) if dense_sizes else 0,
        dense_block_size_max=int(max(dense_sizes)) if dense_sizes else 0,
    )
    return info


def print_hmatrix_information(h: HMatrix) -> str:
    """Pretty printer (hmatrix_output.hpp:219-236)."""
    info = hmatrix_info(h)
    lines = ["HMatrix information:"]
    for k in sorted(info):
        lines.append(f"  {k:<24} {info[k]}")
    s = "\n".join(lines)
    print(s)
    return s
