from .aca import batched_partial_aca
from .assembly import HMatrixBuilder, assemble_from_plan, build_hmatrix
from .block_tree import BlockTreePlan, plan_block_tree, rjasanow_steinbach
from .hmatrix import DenseBucket, HMatrix, LowRankBucket
from .info import hmatrix_info, print_hmatrix_information
from .linalg import (
    copy_diagonal,
    matmat,
    matmat_user,
    matvec,
    matvec_user,
    prepare_tiled_matvec,
    to_dense,
)
