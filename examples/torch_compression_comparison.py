"""Compressor comparison with the PyTorch port
(``examples/compression_comparison.cpp:60-100`` analog, as
``examples/compression_comparison.py`` drives it in the JAX package): error
against rank of partial ACA, full ACA and the truncated SVD on the kernel
block between two clouds, written as a CSV into ``--outdir``.

    python examples/torch_compression_comparison.py --outdir out
    python examples/torch_compression_comparison.py --outdir out --device cpu
"""

import argparse
import csv
import os

import torch

import htool_tpu_torch as ht
from htool_tpu_torch.hmatrix.aca import batched_partial_aca
from htool_tpu_torch.hmatrix.compressors import batched_full_aca, batched_svd_compress
from htool_tpu_torch.testing import create_sphere, laplace_kernel

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
ap.add_argument("--m", type=int, default=500, help="points of the target cloud")
ap.add_argument("--n", type=int, default=100, help="points of the source cloud")
ap.add_argument("--max-rank", type=int, default=50)
ap.add_argument("--outdir", required=True, help="directory for compression_comparison.csv")
args = ap.parse_args()
ht.set_default_device(args.device)
os.makedirs(args.outdir, exist_ok=True)

m, n = args.m, args.n
tp = create_sphere(m, radius=1.0, seed=0)
sp = create_sphere(n, radius=1.0, center=(0.0, 0.0, 3.0), seed=1)
gen = ht.KernelGenerator(laplace_kernel, tp, sp)
A = gen.to_dense()
normA = float(torch.linalg.norm(A))

dev = gen.device
rows = torch.arange(m, device=dev)[None]
cols = torch.arange(n, device=dev)[None]
tsz = torch.tensor([m], device=dev)
ssz = torch.tensor([n], device=dev)

out_rows = []
for name, fn in (("partialACA", batched_partial_aca), ("fullACA", batched_full_aca),
                 ("SVD", batched_svd_compress)):
    for rank in range(1, args.max_rank + 1):
        U, V, rk, failed = fn(gen, rows, cols, tsz, ssz, 1e-16, rank, rank)
        err = float(torch.linalg.norm(U[0] @ V[0] - A)) / normA
        out_rows.append(dict(compressor=name, rank=rank, error=err))
    print(f"{name}: rank {args.max_rank} error {out_rows[-1]['error']:.3e}")

path = os.path.join(args.outdir, "compression_comparison.csv")
with open(path, "w", newline="") as f:
    w = csv.DictWriter(f, fieldnames=["compressor", "rank", "error"])
    w.writeheader()
    w.writerows(out_rows)
print("saved:", path)
print("plot with: python tools/plot_comparison_compression.py", path)
