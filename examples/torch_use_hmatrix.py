"""H-matrix example with the PyTorch port (``examples/use_hmatrix.cpp``
analog, as ``examples/use_hmatrix.py`` drives it in the JAX package):
compress a Laplace kernel matrix on a sphere in symmetric storage, print its
information, apply it to a vector, and write the block structure with each
leaf's rank into ``--outdir``.

Run on the GPU (the default) or on the CPU:

    python examples/torch_use_hmatrix.py --outdir out
    python examples/torch_use_hmatrix.py --outdir out --device cpu
"""

import argparse
import os

import numpy as np
import torch

import htool_tpu_torch as ht
from htool_tpu_torch.hmatrix.output import save_leaves_with_rank
from htool_tpu_torch.testing import create_sphere, laplace_kernel_symmetric

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
ap.add_argument("--n", type=int, default=5000)
ap.add_argument("--outdir", required=True, help="directory for hmatrix_leaves.csv")
args = ap.parse_args()
ht.set_default_device(args.device)
os.makedirs(args.outdir, exist_ok=True)

n = args.n
pts = create_sphere(n)
gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts)
tree = ht.build_cluster_tree(pts, max_leaf_size=100)
H = ht.build_hmatrix(gen, tree, epsilon=1e-3, eta=10.0, symmetry="S", UPLO="L")
ht.print_hmatrix_information(H)

x = torch.as_tensor(np.random.RandomState(0).randn(n), device=H.device)
y = H @ x
print("matvec done, |y| =", float(torch.linalg.norm(y)))

path = os.path.join(args.outdir, "hmatrix_leaves.csv")
save_leaves_with_rank(H, path)
print("saved:", path)
print("plot with: python tools/plot_hmatrix.py", path)
