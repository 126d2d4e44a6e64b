from .ddm import BLRSchwarzPreconditioner, DDMSolver, SchwarzPreconditioner, build_geometric_overlap
from .geneo import GeneoCoarseSpace, build_geneo_coarse_space
from .krylov import KrylovResult, block_gmres, cg, gmres

__all__ = [
    "DDMSolver",
    "SchwarzPreconditioner",
    "BLRSchwarzPreconditioner",
    "build_geometric_overlap",
    "GeneoCoarseSpace",
    "build_geneo_coarse_space",
    "KrylovResult",
    "cg",
    "gmres",
    "block_gmres",
]
