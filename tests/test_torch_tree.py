"""Parity of the port's python-backend host planners with the JAX package's:
sphere points, cluster trees and block-tree leaf sets.  The native planner's
parity is in ``test_torch_native_planner.py``."""

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import htool_tpu as hj
import htool_tpu_torch as ht
import torch_parity  # noqa: F401  (asks the port for the CPU)
from htool_tpu.testing import create_sphere as sphere_jax
from htool_tpu_torch.testing import create_sphere as sphere_torch


@pytest.mark.parametrize("n,seed", [(1, 0), (777, 0), (2000, 3)])
def test_create_sphere_bit_equal(n, seed):
    a = sphere_jax(n, seed=seed)
    b = sphere_torch(n, seed=seed)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("n_partitions", [1, 4])
@pytest.mark.parametrize("direction,splitting", [("pca", "regular"), ("bounding_box", "geometric")])
def test_cluster_tree_parity(n_partitions, direction, splitting):
    pts = sphere_jax(1200)
    kw = dict(max_leaf_size=40, direction=direction, splitting=splitting)
    tj = hj.ClusterTreeBuilder(backend="python", **kw).build(pts, n_partitions=n_partitions)
    tt = ht.ClusterTreeBuilder(backend="python", **kw).build(pts, n_partitions=n_partitions)
    for name in ("permutation", "offsets", "sizes", "depths", "parents", "children",
                 "ranks", "partition_roots"):
        assert np.array_equal(getattr(tj, name), getattr(tt, name)), name
    np.testing.assert_array_equal(tj.centers, tt.centers)
    np.testing.assert_array_equal(tj.radii, tt.radii)


def _leafset(plan):
    key = lambda l: (l.t_off, l.t_size, l.s_off, l.s_size, l.mirror)
    return sorted(map(key, plan.dense)), sorted(map(key, plan.admissible))


@pytest.mark.parametrize("symmetry,UPLO", [("N", "N"), ("S", "L")])
def test_block_tree_leafset_parity(symmetry, UPLO):
    pts = sphere_jax(900)
    tj = hj.ClusterTreeBuilder(max_leaf_size=35, backend="python").build(pts, n_partitions=2)
    tt = ht.ClusterTreeBuilder(max_leaf_size=35, backend="python").build(pts, n_partitions=2)
    kw = dict(epsilon=1e-4, eta=10.0, symmetry=symmetry, UPLO=UPLO)
    pj = hj.plan_block_tree(tj, backend="python", **kw)
    pt = ht.plan_block_tree(tt, backend="python", **kw)
    assert _leafset(pj) == _leafset(pt)
    assert len(pt.admissible) > 0 and len(pt.dense) > 0
    pj1 = hj.plan_block_tree(tj, target_partition=1, backend="python", **kw)
    pt1 = ht.plan_block_tree(tt, target_partition=1, backend="python", **kw)
    assert _leafset(pj1) == _leafset(pt1)
