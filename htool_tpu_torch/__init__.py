"""htool_tpu_torch — the PyTorch / CUDA port of htool_tpu.

Hierarchical matrices and domain-decomposition solvers on an NVIDIA GPU:
geometric cluster trees, H-matrix compression (batched partial or full
ACA, truncated SVD, SVD recompression), products through hand-written
CUDA kernels (``csrc/``: tiled plans and unplanned buckets), and
restarted GMRES / block GMRES / CG with one-level Schwarz preconditioners
and the two-level GenEO coarse space, for real and complex operators.  The JAX
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
    "save_hmatrix",
    "load_hmatrix",
    "GeneoCoarseSpace",
    "build_geneo_coarse_space",
    "set_default_device",
    "get_default_device",
]
