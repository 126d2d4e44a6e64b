"""Flat bucketed H-matrix container (dataclasses of tensors).

Port of ``htool_tpu/hmatrix/hmatrix.py``: all leaves live in a handful of
stacked 3-D tensors ("buckets") grouped by padded block shape — dense
buckets ``[nb, bm, bn]`` and low-rank buckets ``U [nb, bm, r] / V [nb, r,
bn]`` (the ``LowRankMatrix`` equivalent, ``hmatrix/lrmat/lrmat.hpp:15-128``)
— plus int64 offset tensors into the cluster numbering.  Padded
rows/cols/ranks are exact zeros, so products need no masks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

__all__ = ["DenseBucket", "LowRankBucket", "HMatrix"]


@dataclass
class DenseBucket:
    """Stacked same-shape dense leaves."""

    data: torch.Tensor  # [nb, bm, bn]
    t_off: torch.Tensor  # [nb] int64, cluster numbering
    s_off: torch.Tensor  # [nb] int64
    # host-side true sizes (padding bookkeeping / info only)
    t_sizes: np.ndarray = None
    s_sizes: np.ndarray = None
    mirror: bool = False  # symmetric mirrored contribution in products
    # optional tiled-matvec plans (ops/tiled_matvec.py), by output side
    plan_t: Any = None
    plan_s: Any = None

    @property
    def n_blocks(self) -> int:
        return int(self.data.shape[0])

    @property
    def block_shape(self) -> tuple[int, int]:
        return (int(self.data.shape[1]), int(self.data.shape[2]))


@dataclass
class LowRankBucket:
    """Stacked same-shape low-rank leaves (U·V factorization)."""

    U: torch.Tensor  # [nb, bm, r]
    V: torch.Tensor  # [nb, r, bn]
    t_off: torch.Tensor  # [nb] int64
    s_off: torch.Tensor  # [nb] int64
    t_sizes: np.ndarray = None
    s_sizes: np.ndarray = None
    ranks: np.ndarray = None  # true ranks per block (host)
    mirror: bool = False
    plan_t: Any = None
    plan_s: Any = None

    @property
    def n_blocks(self) -> int:
        return int(self.U.shape[0])

    @property
    def block_shape(self) -> tuple[int, int]:
        return (int(self.U.shape[1]), int(self.V.shape[2]))

    @property
    def rank_padded(self) -> int:
        return int(self.U.shape[2])


@dataclass
class HMatrix:
    """Flat H-matrix over cluster numbering, with user-numbering wrappers.

    ``shape`` is the (local target span, source span) in cluster numbering;
    ``t_root_off`` is the cluster-numbering offset of the (possibly
    partition-restricted) target root, so a partition-local block-row stores
    rows ``[t_root_off, t_root_off + shape[0])`` of the global operator
    (reference ``reset_root_of_block_tree``, tree_builder.hpp:533-566).
    """

    shape: tuple[int, int]
    dense_buckets: list
    lr_buckets: list
    perm_t: torch.Tensor  # [M_global] int64, cluster -> user
    perm_s: torch.Tensor  # [N_global] int64
    symmetry: str = "N"
    UPLO: str = "N"
    t_root_off: int = 0
    s_root_off: int = 0
    info: dict = field(default_factory=dict)

    @property
    def dtype(self) -> torch.dtype:
        for b in self.dense_buckets:
            return b.data.dtype
        for b in self.lr_buckets:
            return b.U.dtype
        return torch.float32

    @property
    def device(self) -> torch.device:
        return self.perm_t.device

    # ------------------------------------------------------------------
    def __matmul__(self, x):
        from .linalg import matvec_user

        return matvec_user(self, x)

    def to_dense(self, user_numbering: bool = True) -> np.ndarray:
        from .linalg import to_dense

        return to_dense(self, user_numbering=user_numbering)

    def get_info(self) -> dict:
        from .info import hmatrix_info

        return hmatrix_info(self)
