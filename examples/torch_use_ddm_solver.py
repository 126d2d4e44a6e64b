"""Full DDM pipeline with the PyTorch port (``examples/use_ddm_solver.cpp:
59-136`` analog, as ``examples/use_ddm_solver.py`` drives it in the JAX
package): sphere → cluster tree → H-matrix → one-level RAS + CG, then the
two-level GenEO coarse space with the deflated correction + GMRES.

Run on the GPU (the default) or on the CPU:

    python examples/torch_use_ddm_solver.py
    python examples/torch_use_ddm_solver.py --device cpu --n 2000
"""

import argparse

import numpy as np

import htool_tpu_torch as ht
from htool_tpu_torch.hmatrix.linalg import matvec as h_matvec
from htool_tpu_torch.solvers import DDMSolver, build_geneo_coarse_space, build_geometric_overlap
from htool_tpu_torch.testing import create_sphere, laplace_kernel_symmetric

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
ap.add_argument("--n", type=int, default=4000)
args = ap.parse_args()
ht.set_default_device(args.device)

n, P = args.n, 8
pts = create_sphere(n)
tree = ht.build_cluster_tree(pts, max_leaf_size=100, n_partitions=P)
gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts)
H = ht.build_hmatrix(gen, tree, epsilon=1e-4, eta=10.0)
b = np.random.RandomState(0).randn(n)

solver = DDMSolver(H, gen, tree, schwarz="ras", overlap_radius=0.15)
x, infos = solver.solve(b, tol=1e-6, maxiter=200, krylov="cg")
print("one-level RAS + CG:", {k: infos[k] for k in ("Nb_it", "Residual", "Converged")})

overlap = build_geometric_overlap(tree, 0.15)
coarse = build_geneo_coarse_space(gen, tree, overlap, lambda v: h_matvec(H, v), nu=2,
                                  symmetry="S")
solver2 = DDMSolver(H, gen, tree, schwarz="ras", overlap=overlap, coarse=coarse,
                    coarse_correction="deflated")
x2, infos2 = solver2.solve(b, tol=1e-6, maxiter=200, krylov="gmres")
print("two-level GenEO + GMRES:", {k: infos2[k] for k in ("Nb_it", "Residual", "Converged")})
