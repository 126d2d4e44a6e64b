from .ddm import BLRSchwarzPreconditioner, DDMSolver, SchwarzPreconditioner, build_geometric_overlap
from .dist_ddm import DistributedDDMSolver, HaloExchange, build_halo_exchange
from .geneo import GeneoCoarseSpace, build_geneo_coarse_space
from .krylov import KrylovResult, block_gmres, cg, gmres

__all__ = [
    "DDMSolver",
    "DistributedDDMSolver",
    "HaloExchange",
    "build_halo_exchange",
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
