"""Cluster-tree CSV files of the port against the JAX package's readers and
writers: a tree written by one package is read by the other, and both write
the same bytes."""

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import htool_tpu as hj
import htool_tpu_torch as ht
import torch_parity  # noqa: F401  (asks the port for the CPU)
from htool_tpu.clustering import io as io_jax
from htool_tpu.testing import create_sphere
from htool_tpu_torch.clustering import io as io_torch
from htool_tpu_torch.convert import tree_from_numpy
from torch_parity import tree_fields

FIELDS = ("permutation", "offsets", "sizes", "depths", "parents", "child_start", "child_count",
          "children", "ranks", "counters", "partition_roots", "centers", "radii")


@pytest.fixture(scope="module")
def trees():
    pts = create_sphere(500, seed=1)
    tj = hj.ClusterTreeBuilder(max_leaf_size=30, backend="python").build(pts, n_partitions=3)
    return pts, tj, tree_from_numpy(tree_fields(tj))


def _assert_same(a, b):
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)),
                                      err_msg=name)
    assert a.is_permutation_local == b.is_permutation_local
    assert a.max_leaf_size == b.max_leaf_size


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tree_files_cross_read(tmp_path, trees, writer):
    pts, tj, tt = trees
    prefix = str(tmp_path / "tree")
    if writer == "jax":
        io_jax.save_cluster_tree(tj, prefix)
        back = io_torch.read_cluster_tree(prefix, pts)
        assert isinstance(back, ht.ClusterTree)
        _assert_same(back, tt)
    else:
        io_torch.save_cluster_tree(tt, prefix)
        _assert_same(io_jax.read_cluster_tree(prefix, pts), tj)
        _assert_same(io_torch.read_cluster_tree(prefix, pts), tt)


def test_same_bytes_and_wrong_points(tmp_path, trees):
    pts, tj, tt = trees
    io_jax.save_cluster_tree(tj, str(tmp_path / "j"))
    io_torch.save_cluster_tree(tt, str(tmp_path / "t"))
    for suffix in ("_properties.csv", "_tree.csv"):
        assert (tmp_path / ("j" + suffix)).read_bytes() == (tmp_path / ("t" + suffix)).read_bytes()
    with pytest.raises(ValueError, match="does not match"):
        io_torch.read_cluster_tree(str(tmp_path / "t"), pts[:-1])


@pytest.mark.parametrize("depth", [1, 3])
def test_clustered_geometry(tmp_path, trees, depth):
    _, tj, tt = trees
    io_jax.save_clustered_geometry(tj, depth, str(tmp_path / "j.csv"))
    io_torch.save_clustered_geometry(tt, depth, str(tmp_path / "t.csv"))
    assert (tmp_path / "j.csv").read_bytes() == (tmp_path / "t.csv").read_bytes()
    labels = np.loadtxt(tmp_path / "t.csv", delimiter=",", skiprows=1)[:, -1]
    assert len(np.unique(labels)) == int(np.sum(tt.depths == depth))
