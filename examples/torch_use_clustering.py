"""Cluster-tree example with the PyTorch port (``examples/use_clustering.cpp``
analog, as ``examples/use_clustering.py`` drives it in the JAX package):
build a PCA cluster tree over a sphere with 4 partitions, save it into
``--outdir``, read it back, and write the clustered geometry for plotting.

    python examples/torch_use_clustering.py --outdir out
"""

import argparse
import os

import numpy as np

import htool_tpu_torch as ht
from htool_tpu_torch.clustering.io import (
    read_cluster_tree,
    save_cluster_tree,
    save_clustered_geometry,
)
from htool_tpu_torch.testing import create_sphere

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda",
                help='"cuda" (default) or "cpu"; the tree is built on the host either way')
ap.add_argument("--n", type=int, default=2000)
ap.add_argument("--outdir", required=True, help="directory for the tree and geometry files")
args = ap.parse_args()
ht.set_default_device(args.device)
os.makedirs(args.outdir, exist_ok=True)

pts = create_sphere(args.n)
tree = ht.build_cluster_tree(pts, max_leaf_size=100, n_partitions=4)
print(f"nodes={tree.n_nodes} partitions={tree.n_partitions}")
offs, sizes = tree.partition_offsets_sizes()
print("partition sizes:", sizes.tolist())

prefix = os.path.join(args.outdir, "sphere")
save_cluster_tree(tree, prefix)
tree2 = read_cluster_tree(prefix, pts)
if not np.array_equal(tree.permutation, tree2.permutation):
    raise SystemExit("the tree read back differs from the tree saved")
geometry = os.path.join(args.outdir, "sphere_clustered.csv")
save_clustered_geometry(tree, 2, geometry)
print("saved:", prefix + "_*.csv", "and", geometry)
print("plot with: python tools/plot_cluster.py", geometry)
