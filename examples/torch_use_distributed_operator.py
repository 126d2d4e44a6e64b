"""Distributed operator with the PyTorch port (``examples/use_distributed_operator.py``
in the JAX package, the reference's ``examples/use_distributed_operator.cpp``):
the row-partitioned H-matrix over a mesh of P partitions, its global-to-global
(g2g) and local-to-local (l2l) products and its information.  Run alone,
the P partitions live on one device of this process; under a launcher, each
rank holds P / W of them on its own card (gloo on the CPU).

Run on the GPU (the default) or on the CPU, in one process or one a card:

    python examples/torch_use_distributed_operator.py
    python examples/torch_use_distributed_operator.py --device cpu
    torchrun --nproc-per-node=4 examples/torch_use_distributed_operator.py
"""

import argparse

import numpy as np
import torch

import htool_tpu_torch as ht
from htool_tpu_torch.parallel import (
    build_distributed_hmatrix,
    default_mesh,
    global_mesh,
    initialize_multihost,
    is_multihost,
    print_distributed_hmatrix_information,
    shutdown_multihost,
)
from htool_tpu_torch.testing import create_sphere, laplace_kernel_symmetric

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
ap.add_argument("--n", type=int, default=4000)
ap.add_argument("--partitions", type=int, default=4)
args = ap.parse_args()
ht.set_default_device(args.device)
initialize_multihost(device=args.device)  # under a launcher: one rank a card; else nothing
mesh = global_mesh if is_multihost() else default_mesh

n, P = args.n, args.partitions
pts = create_sphere(n)
tree = ht.build_cluster_tree(pts, max_leaf_size=100, n_partitions=P)
gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts, dtype=torch.float64)
D = build_distributed_hmatrix(gen, tree, mesh(P), epsilon=1e-3, eta=10.0)
print(f"partitions={P} on {D.device}, sizes={D.part_sizes.tolist()}, m_loc_max={D.m_loc_max}")

x = torch.as_tensor(np.random.RandomState(0).randn(n), device=D.device)
y = D.matvec(x)  # global-to-global
yt = D.matvec(x, op="T")
perm = torch.as_tensor(tree.permutation, device=D.device)
y_loc = D.matvec_local(D.to_local_layout(x[perm]))  # local-to-local, cluster numbering
print(f"|A x| = {float(torch.linalg.norm(y)):.6g}, |A^T x| = {float(torch.linalg.norm(yt)):.6g}")
print("l2l == g2g:", bool(torch.allclose(D.to_global_layout(y_loc), y[perm],
                                         atol=1e-10 * float(torch.linalg.norm(y)))))
print_distributed_hmatrix_information(D)
shutdown_multihost()
