from .ddm import DDMSolver, SchwarzPreconditioner, build_geometric_overlap
from .krylov import KrylovResult, cg, gmres

__all__ = [
    "DDMSolver",
    "SchwarzPreconditioner",
    "build_geometric_overlap",
    "KrylovResult",
    "cg",
    "gmres",
]
