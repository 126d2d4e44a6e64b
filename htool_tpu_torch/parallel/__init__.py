from .collectives import Mesh
from .distributed import (
    DistributedHMatrix,
    build_distributed_from_local_hmatrices,
    build_distributed_hmatrix,
    default_mesh,
)
from .info import distributed_hmatrix_info, print_distributed_hmatrix_information
from .multihost import global_mesh, initialize_multihost, is_multihost, shutdown_multihost

__all__ = ["Mesh", "DistributedHMatrix", "build_distributed_hmatrix",
           "build_distributed_from_local_hmatrices", "default_mesh", "global_mesh",
           "initialize_multihost", "shutdown_multihost", "is_multihost",
           "distributed_hmatrix_info",
           "print_distributed_hmatrix_information"]
