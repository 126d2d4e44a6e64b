"""Compressed factorization with the PyTorch port: the reference's
``lu_factorization`` / ``lu_solve`` surface (``hmatrix/linalg/factorization.hpp:82-290``)
on an assembled H-matrix, as ``examples/use_factorization.py`` drives it in
the JAX package: the flat one-level BLR LU through the assembled operator,
then the nested three-level format straight from the generator.

Run on the GPU (the default) or on the CPU:

    python examples/torch_use_factorization.py
    python examples/torch_use_factorization.py --device cpu
"""

import argparse

import numpy as np
import torch

import htool_tpu_torch as ht
from htool_tpu_torch.testing import create_sphere, laplace_kernel_symmetric

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
ap.add_argument("--n", type=int, default=3000)
args = ap.parse_args()
ht.set_default_device(args.device)

n = args.n
pts = create_sphere(n)
gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts, dtype=torch.float64)
tree = ht.build_cluster_tree(pts, max_leaf_size=64)

# assemble the compressed operator, then factorize THROUGH the assembled
# H-matrix (to_blr re-tiling, no generator re-evaluation)
H = ht.build_hmatrix(gen, tree, epsilon=1e-6, eta=10.0)
F = ht.lu_factorization(H, tree, epsilon=1e-8, method="blr", block_size=128)
x = torch.as_tensor(np.random.RandomState(0).randn(n), device=H.device)
b = H @ x
sol = ht.lu_solve(F, b)
print(f"flat BLR LU   : rel err {float(torch.linalg.norm(sol - x) / torch.linalg.norm(x)):.2e}, "
      f"residual {float(torch.linalg.norm(H @ sol - b) / torch.linalg.norm(b)):.2e}, "
      f"{F.nL} cells, backward error {F.info['backward_error_est']:.2e}")

# nested three-level factorization straight from the generator
A3 = ht.build_blr2(gen, tree, epsilon=1e-8, coarse_size=1024, diag_mode="nested", mid_size=256)
F3 = ht.blr2_lu(A3)
sol3 = ht.blr2_solve(F3, b, user_numbering=True)
print(f"nested (3-lvl): rel err {float(torch.linalg.norm(sol3 - x) / torch.linalg.norm(x)):.2e}, "
      f"levels {A3.info['n_levels']}, factor bytes {F3.memory_bytes():,}, "
      f"backward error {F3.info['backward_error_est']:.2e}")
