"""Peaks of the device, and the bytes an H-matrix product has to move.

The product is bound by device memory: each stored coefficient is read once
a product for 2·k (8·k complex) flops.  Its least time is the bytes it must
move over the device's memory bandwidth.
"""

from __future__ import annotations

import numpy as np

# HBM bandwidth, bytes/s, by a part of the name ``torch.cuda.get_device_name``
# gives: NVIDIA's data sheet for the H100 SXM (80 GB HBM3), at its 700 W limit
HBM_BYTES_PER_S = {"H100": 3.35e12}


def peak_bandwidth(kind: str):
    """The device's memory bandwidth in bytes/s, or None for a device not in
    the table (a CPU, for one)."""
    for key, value in HBM_BYTES_PER_S.items():
        if key in kind:
            return value
    return None


def product_bytes(H, k: int) -> int:
    """Bytes one product ``H @ x`` with k columns must move: every stored
    coefficient once (a dense block m·n, a low-rank block r·(m + n), at the
    blocks' true sizes and ranks, as ``hmatrix_info`` counts generated
    coefficients; padding is not work), x read once and y written once."""
    item = _itemsize(H)
    coeffs = 0
    for b in H.dense_buckets:
        coeffs += int(np.sum(_i64(b.t_sizes) * _i64(b.s_sizes)))
    for b in H.lr_buckets:
        coeffs += int(np.sum(_i64(b.ranks) * (_i64(b.t_sizes) + _i64(b.s_sizes))))
    m, n = H.shape
    return item * (coeffs + k * (m + n))


def _i64(a) -> np.ndarray:
    return np.asarray(a, dtype=np.int64)


def _itemsize(H) -> int:
    import torch

    return torch.empty((), dtype=H.dtype).element_size()
