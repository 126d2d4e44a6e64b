"""Distributed DDM solve with the PyTorch port (``examples/use_distributed_ddm.py``
in the JAX package): the operator row-partitioned over P partitions, the
Krylov vectors held as per-partition slices, the Schwarz preconditioner's
halo exchange and subdomain solves per partition, dot products summed over
the partitions; one-level RAS, a GenEO two-level correction, and block GMRES
on several right-hand sides.  Run alone, the P partitions live on one device
of this process; under a launcher, each rank holds P / W of them on its own
card (gloo on the CPU).

Run on the GPU (the default) or on the CPU, in one process or one a card:

    python examples/torch_use_distributed_ddm.py
    python examples/torch_use_distributed_ddm.py --device cpu
    torchrun --nproc-per-node=4 examples/torch_use_distributed_ddm.py
"""

import argparse

import numpy as np
import torch

import htool_tpu_torch as ht
from htool_tpu_torch.hmatrix.linalg import matvec
from htool_tpu_torch.parallel import (
    build_distributed_hmatrix,
    default_mesh,
    global_mesh,
    initialize_multihost,
    is_multihost,
    shutdown_multihost,
)
from htool_tpu_torch.solvers import (
    DistributedDDMSolver,
    build_geneo_coarse_space,
    build_geometric_overlap,
)
from htool_tpu_torch.testing import create_sphere, laplace_kernel_symmetric

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
ap.add_argument("--n", type=int, default=4000)
ap.add_argument("--partitions", type=int, default=8)
args = ap.parse_args()
ht.set_default_device(args.device)
initialize_multihost(device=args.device)  # under a launcher: one rank a card; else nothing
mesh = global_mesh if is_multihost() else default_mesh

n, P = args.n, args.partitions
print(f"partitions: {P}, points: {n}")
pts = create_sphere(n)
gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts, dtype=torch.float64)
tree = ht.build_cluster_tree(pts, max_leaf_size=64, n_partitions=P)
D = build_distributed_hmatrix(gen, tree, mesh(P), epsilon=1e-6, eta=10.0)

overlap = build_geometric_overlap(tree, 0.15)
b = np.random.default_rng(0).standard_normal(n)

# one-level RAS on the partition slices
solver = DistributedDDMSolver(D, gen, tree, schwarz="ras", overlap=overlap)
x, infos = solver.solve(b, tol=1e-6, krylov="gmres")
print("one-level RAS:", {k: infos[k] for k in ("Nb_it", "Residual", "Converged")})

# two-level GenEO (batched EVPs on the device), deflated correction
H = ht.build_hmatrix(gen, tree, epsilon=1e-6, eta=10.0)
coarse = build_geneo_coarse_space(gen, tree, overlap, lambda v: matvec(H, v), nu=2,
                                  symmetry="S")
solver2 = DistributedDDMSolver(D, gen, tree, schwarz="ras", overlap=overlap, coarse=coarse,
                               coarse_correction="deflated")
x2, infos2 = solver2.solve(b, tol=1e-6, krylov="gmres")
print("two-level GenEO:", {k: infos2[k] for k in ("Nb_it", "Residual", "Coarse_size")})

# block GMRES for multiple right-hand sides (one shared Krylov subspace)
B = np.random.default_rng(1).standard_normal((n, 4))
x3, infos3 = solver.solve(B, tol=1e-6, krylov="block_gmres")
print("block GMRES (4 rhs):", {k: infos3[k] for k in ("Nb_it", "Residual")})
shutdown_multihost()
