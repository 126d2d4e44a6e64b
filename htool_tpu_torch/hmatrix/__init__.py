from .aca import batched_partial_aca
from .assembly import HMatrixBuilder, assemble_from_plan, build_hmatrix, hmatrix_from_dense
from .block_tree import BlockTreePlan, plan_block_tree, rjasanow_steinbach
from .blr import BLRMatrix, blr_cholesky, blr_lu, blr_matmul, blr_matvec, blr_solve, build_blr
from .blr2 import (
    TwoLevelBLR,
    blr2_backward_error,
    blr2_cholesky,
    blr2_lu,
    blr2_matvec,
    blr2_solve,
    build_blr2,
)
from .compressors import (
    batched_full_aca,
    batched_recompress,
    batched_svd_compress,
    svd_truncation_rank,
)
from .hmatrix import DenseBucket, HMatrix, LowRankBucket
from .info import hmatrix_info, print_hmatrix_information
from .linalg import (
    copy_diagonal,
    copy_diagonal_user,
    matmat,
    matmat_user,
    matvec,
    matvec_user,
    prepare_tiled_matvec,
    to_dense,
)
from .lr_linalg import (
    LowRank,
    add_lrmat_lrmat,
    hmatrix_lrmat_product,
    lrmat_from_dense,
    lrmat_hmatrix_product,
    lrmat_lrmat_product,
    lrmat_matrix_product,
    lrmat_vector_product,
    matrix_hmatrix_product,
    matrix_lrmat_product,
    scale_lrmat,
)
from .output import load_hmatrix, save_hmatrix, save_leaves_with_rank, save_levels, view_block_tree
from .conversion import (
    cholesky_factorization,
    cholesky_solve,
    common_grid_blr,
    hmatrix_hmatrix_product,
    lu_factorization,
    lu_solve,
    recompress_hmatrix,
    retile_blr,
    to_blr,
    to_blr2,
)
