"""Cluster-tree persistence — CSV save/load
(``clustering/cluster_output.hpp``: ``save_cluster_tree:33``,
``read_cluster_tree:87``, ``save_clustered_geometry:189``).

Format: ``{prefix}_properties.csv`` holds scalars + the permutation;
``{prefix}_tree.csv`` holds one row per node.  Cluster trees can thus be
built once and reloaded (the reference's solver tests reload pre-built
trees the same way, test_solver_ddm.hpp:110).

A copy of ``htool_tpu/clustering/io.py`` over the port's
:class:`~htool_tpu_torch.clustering.cluster_tree.ClusterTree`; the files
are the same in both packages.
"""

from __future__ import annotations

import csv

import numpy as np

from .cluster_tree import ClusterTree

__all__ = ["save_cluster_tree", "read_cluster_tree", "save_clustered_geometry"]

_NODE_FIELDS = [
    "offset",
    "size",
    "depth",
    "parent",
    "child_start",
    "child_count",
    "rank",
    "counter",
    "radius",
]


def save_cluster_tree(tree: ClusterTree, prefix: str) -> None:
    with open(prefix + "_properties.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["n_points", tree.n_points])
        w.writerow(["dim", tree.dim])
        w.writerow(["max_leaf_size", tree.max_leaf_size])
        w.writerow(["n_partitions", tree.n_partitions])
        w.writerow(["is_permutation_local", int(tree.is_permutation_local)])
        w.writerow(["permutation"] + tree.permutation.tolist())
        w.writerow(["partition_roots"] + tree.partition_roots.tolist())
        w.writerow(["children"] + tree.children.tolist())
    with open(prefix + "_tree.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(_NODE_FIELDS + [f"center_{d}" for d in range(tree.dim)])
        for n in range(tree.n_nodes):
            row = [
                tree.offsets[n],
                tree.sizes[n],
                tree.depths[n],
                tree.parents[n],
                tree.child_start[n],
                tree.child_count[n],
                tree.ranks[n],
                tree.counters[n],
                tree.radii[n],
            ] + tree.centers[n].tolist()
            w.writerow(row)


def read_cluster_tree(prefix: str, points: np.ndarray) -> ClusterTree:
    props = {}
    with open(prefix + "_properties.csv", newline="") as f:
        for row in csv.reader(f):
            props[row[0]] = row[1:]
    n_points = int(props["n_points"][0])
    dim = int(props["dim"][0])
    points = np.asarray(points, np.float64)
    if points.shape != (n_points, dim):
        raise ValueError(
            f"points shape {points.shape} does not match saved tree "
            f"({n_points}, {dim})"
        )
    with open(prefix + "_tree.csv", newline="") as f:
        r = csv.reader(f)
        next(r)  # the header
        rows = list(r)
    arr = np.array([[float(x) for x in row] for row in rows])
    ncol = len(_NODE_FIELDS)
    return ClusterTree(
        points=points,
        permutation=np.array([int(x) for x in props["permutation"]]),
        offsets=arr[:, 0].astype(np.int64),
        sizes=arr[:, 1].astype(np.int64),
        depths=arr[:, 2].astype(np.int64),
        parents=arr[:, 3].astype(np.int64),
        child_start=arr[:, 4].astype(np.int64),
        child_count=arr[:, 5].astype(np.int64),
        children=np.array([int(x) for x in props["children"]], np.int64),
        ranks=arr[:, 6].astype(np.int64),
        counters=arr[:, 7].astype(np.int64),
        radii=arr[:, 8],
        centers=arr[:, ncol : ncol + dim],
        partition_roots=np.array(
            [int(x) for x in props["partition_roots"]], np.int64
        ),
        is_permutation_local=bool(int(props["is_permutation_local"][0])),
        max_leaf_size=int(props["max_leaf_size"][0]),
    )


def save_clustered_geometry(
    tree: ClusterTree, depth: int, filename: str
) -> None:
    """Per-point cluster label at a given depth, for plotting
    (cluster_output.hpp:189)."""
    labels = np.full(tree.n_points, -1, np.int64)
    for n in range(tree.n_nodes):
        if tree.depths[n] == depth:
            labels[
                tree.permutation[tree.offsets[n] : tree.offsets[n] + tree.sizes[n]]
            ] = n
    with open(filename, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([f"x_{d}" for d in range(tree.dim)] + ["cluster"])
        for i in range(tree.n_points):
            w.writerow(tree.points[i].tolist() + [labels[i]])
