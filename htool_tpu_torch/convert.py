"""Carry cluster trees and H-matrices across from plain NumPy arrays.

Takes NumPy arrays only (no JAX): a caller that holds a JAX object turns
its fields into arrays with ``np.asarray`` and hands them over, so both
packages can work on the same tree or the same compressed operator.
"""

from __future__ import annotations

import numpy as np
import torch

from .clustering.cluster_tree import ClusterTree
from .hmatrix.hmatrix import DenseBucket, HMatrix, LowRankBucket
from .utils.device import resolve_device

__all__ = ["tree_from_numpy", "hmatrix_from_numpy"]


def tree_from_numpy(fields: dict) -> ClusterTree:
    """Build a :class:`ClusterTree` from its fields (``points``,
    ``permutation``, per-node arrays, ``partition_roots``, and the scalars
    ``is_permutation_local``/``max_leaf_size``)."""
    scalars = {"is_permutation_local": bool, "max_leaf_size": int}
    return ClusterTree(**{
        name: scalars[name](value) if name in scalars else np.array(value, copy=True)
        for name, value in fields.items()
    })


def hmatrix_from_numpy(d: dict, device=None) -> HMatrix:
    """Build an :class:`HMatrix` on ``device`` (default: the GPU, see
    :mod:`.utils.device`) from a dict with
    ``shape``, ``symmetry``, ``UPLO``, ``t_root_off``, ``perm_t``,
    ``perm_s`` and the bucket lists ``dense_buckets`` (dicts with ``data``,
    ``t_off``, ``s_off``, ``t_sizes``, ``s_sizes``, ``mirror``) and
    ``lr_buckets`` (dicts with ``U``, ``V``, ``t_off``, ``s_off``,
    ``t_sizes``, ``s_sizes``, ``ranks``, ``mirror``)."""
    device = resolve_device(device)

    def t(a, dtype=None):
        return torch.as_tensor(np.array(a, copy=True), dtype=dtype, device=device)

    def common(b):
        return dict(
            t_off=t(b["t_off"], torch.int64),
            s_off=t(b["s_off"], torch.int64),
            t_sizes=np.asarray(b["t_sizes"], np.int64),
            s_sizes=np.asarray(b["s_sizes"], np.int64),
            mirror=bool(b["mirror"]),
        )

    dense = [DenseBucket(data=t(b["data"]), **common(b)) for b in d["dense_buckets"]]
    lr = [
        LowRankBucket(U=t(b["U"]), V=t(b["V"]), ranks=np.asarray(b["ranks"], np.int64),
                      **common(b))
        for b in d["lr_buckets"]
    ]
    return HMatrix(
        shape=tuple(int(s) for s in d["shape"]),
        dense_buckets=dense,
        lr_buckets=lr,
        perm_t=t(d["perm_t"], torch.int64),
        perm_s=t(d["perm_s"], torch.int64),
        symmetry=str(d["symmetry"]),
        UPLO=str(d["UPLO"]),
        t_root_off=int(d["t_root_off"]),
    )
