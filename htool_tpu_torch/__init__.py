"""htool_tpu_torch — the PyTorch / CUDA port of htool_tpu.

Hierarchical matrices and domain-decomposition solvers on an NVIDIA GPU:
geometric cluster trees, H-matrix compression (batched partial or full
ACA, truncated SVD, SVD recompression), products through hand-written
CUDA kernels (``csrc/``: tiled plans and unplanned buckets), and
restarted GMRES / block GMRES / CG with one-level Schwarz preconditioners
(dense or compressed local solves) and the two-level GenEO coarse space,
for real and complex operators, and compressed factorizations: flat and
two-level BLR LU and Cholesky, their solves, H-matrix conversion and
H×H products, and the row-partitioned distributed operator with its
Schwarz + Krylov solve on partition slices (``parallel/``,
``solvers/dist_ddm.py``).  The JAX
package ``htool_tpu`` is the reference; this package never imports it or
JAX.  Trees and block plans are built on the host (by the C++ planner of
``native/``, or in NumPy where it does not build); the device sees flat,
padded bucket tensors.
"""

from .utils.precision import set_full_precision as _set_full_precision

_set_full_precision()

from .clustering.cluster_tree import ClusterTree, ClusterTreeBuilder, build_cluster_tree
from .generator import Generator, KernelGenerator, MatrixGenerator
from .hmatrix.aca import batched_partial_aca
from .hmatrix.assembly import (
    HMatrixBuilder,
    assemble_from_plan,
    build_hmatrix,
    hmatrix_from_dense,
)
from .hmatrix.block_tree import BlockTreePlan, plan_block_tree
from .hmatrix.blr import (
    BLRMatrix,
    blr_cholesky,
    blr_lu,
    blr_matmul,
    blr_matvec,
    blr_solve,
    build_blr,
)
from .hmatrix.blr2 import (
    TwoLevelBLR,
    blr2_cholesky,
    blr2_lu,
    blr2_matvec,
    blr2_solve,
    blr2_triangular_solve,
    build_blr2,
)
from .hmatrix.conversion import (
    blr_to_hmatrix,
    cholesky_factorization,
    cholesky_solve,
    common_grid_blr,
    hmatrix_hmatrix_product,
    lu_factorization,
    lu_solve,
    permute_blr,
    recompress_hmatrix,
    retile_blr,
    to_blr,
    to_blr2,
)
from .hmatrix.hmatrix import DenseBucket, HMatrix, LowRankBucket
from .hmatrix.info import hmatrix_info, print_hmatrix_information
from .hmatrix.linalg import matmat, matmat_user, matvec, matvec_user, to_dense
from .hmatrix.output import load_hmatrix, save_hmatrix
from .solvers.geneo import GeneoCoarseSpace, build_geneo_coarse_space
from .utils.device import get_default_device, set_default_device

__version__ = "0.1.0"

__all__ = [
    "ClusterTree",
    "ClusterTreeBuilder",
    "build_cluster_tree",
    "Generator",
    "KernelGenerator",
    "MatrixGenerator",
    "BlockTreePlan",
    "plan_block_tree",
    "HMatrix",
    "DenseBucket",
    "LowRankBucket",
    "HMatrixBuilder",
    "build_hmatrix",
    "assemble_from_plan",
    "hmatrix_from_dense",
    "batched_partial_aca",
    "matvec",
    "matvec_user",
    "matmat",
    "matmat_user",
    "to_dense",
    "hmatrix_info",
    "print_hmatrix_information",
    "recompress_hmatrix",
    "to_blr",
    "blr_to_hmatrix",
    "to_blr2",
    "BLRMatrix",
    "build_blr",
    "blr_lu",
    "blr_cholesky",
    "blr_solve",
    "blr_matvec",
    "blr_matmul",
    "TwoLevelBLR",
    "build_blr2",
    "blr2_lu",
    "blr2_cholesky",
    "blr2_solve",
    "blr2_triangular_solve",
    "blr2_matvec",
    "lu_factorization",
    "lu_solve",
    "cholesky_factorization",
    "cholesky_solve",
    "hmatrix_hmatrix_product",
    "retile_blr",
    "permute_blr",
    "common_grid_blr",
    "save_hmatrix",
    "load_hmatrix",
    "GeneoCoarseSpace",
    "build_geneo_coarse_space",
    "set_default_device",
    "get_default_device",
]
