"""The port's native (C++) planner against the JAX package's.

The JAX package's own library is not used: it builds through one shared
temporary path, which processes that build at once can collide on.  The
reference output comes from ``htool_tpu/native/planner.cpp`` compiled here
into a test directory and driven through the port's bindings.  The port's
library is built by its own ``get_lib``; the last test shows that two
processes building it into one directory at once both succeed."""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import htool_tpu as hj
import htool_tpu_torch as ht
import torch_parity  # noqa: F401  (asks the port for the CPU)
from htool_tpu.testing import create_sphere
from htool_tpu_torch import native
from htool_tpu_torch.clustering.cluster_tree import ClusterTree
from test_clustering import check_tree_invariants

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE_FIELDS = ("permutation", "offsets", "sizes", "depths", "parents", "child_start",
               "child_count", "children", "ranks", "counters", "partition_roots")


@pytest.fixture(scope="module")
def ref_lib(tmp_path_factory):
    """The JAX package's planner source, compiled into a directory of this
    module's own."""
    src = os.path.join(ROOT, "htool_tpu", "native", "planner.cpp")
    return native.load_library(native.build_library(src, str(tmp_path_factory.mktemp("ref"))))


def _ref_tree(ref_lib, pts, max_leaf_size, n_partitions, direction="pca", partition=None):
    out = native.ct_build_native(pts, max_leaf_size, 2, direction, "regular", n_partitions,
                                 partition, False, None, None, lib=ref_lib)
    return ClusterTree(points=np.asarray(pts, np.float64), max_leaf_size=max_leaf_size, **out)


def _assert_same_tree(a, b):
    for name in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    np.testing.assert_array_equal(a.centers, b.centers)
    np.testing.assert_array_equal(a.radii, b.radii)
    assert a.is_permutation_local == b.is_permutation_local


def test_the_port_builds_its_own_library():
    assert native.native_available()
    so = native.get_lib()._name
    assert os.path.dirname(so) == native.BUILD_DIR and os.path.basename(so) == "libplanner.so"


@pytest.mark.parametrize("n_partitions", [1, 3, 4])
@pytest.mark.parametrize("direction", ["pca", "bounding_box"])
def test_default_tree_is_the_native_one(ref_lib, n_partitions, direction):
    """ClusterTreeBuilder() with no backend gives the reference's native
    tree; with PCA directions (the default) that tree is not the NumPy
    builder's (the planners compute the principal axis differently)."""
    pts = create_sphere(700)
    calls = native.ct_build_native.calls
    tree = ht.ClusterTreeBuilder(max_leaf_size=40, direction=direction).build(
        pts, n_partitions=n_partitions)
    assert native.ct_build_native.calls == calls + 1
    check_tree_invariants(tree)
    assert tree.n_partitions == n_partitions
    _assert_same_tree(tree, _ref_tree(ref_lib, pts, 40, n_partitions, direction))
    python = ht.ClusterTreeBuilder(max_leaf_size=40, direction=direction,
                                   backend="python").build(pts, n_partitions=n_partitions)
    if direction == "pca":
        assert not np.array_equal(tree.permutation, python.permutation)


def test_build_cluster_tree_is_native(ref_lib):
    pts = create_sphere(1000, seed=2)
    tree = ht.build_cluster_tree(pts, max_leaf_size=64, n_partitions=4)
    _assert_same_tree(tree, _ref_tree(ref_lib, pts, 64, 4))


def test_given_partition(ref_lib):
    pts = create_sphere(300)
    part = np.repeat(np.arange(3), 100)
    tree = ht.ClusterTreeBuilder(max_leaf_size=20, backend="native").build(
        pts, n_partitions=3, partition=part)
    check_tree_invariants(tree)
    offs, sizes = tree.partition_offsets_sizes()
    for p in range(3):
        assert np.all(part[tree.permutation[offs[p] : offs[p] + sizes[p]]] == p)
    _assert_same_tree(tree, _ref_tree(ref_lib, pts, 20, 3, partition=part))


def _leafset(plan):
    key = lambda l: (l.t_off, l.t_size, l.s_off, l.s_size, l.mirror)
    return sorted(map(key, plan.dense)), sorted(map(key, plan.admissible))


def _ref_leafset(ref_lib, tree, symmetry, UPLO, target_partition=-1):
    dense, adm = native.bt_plan_native(tree, tree, 10.0, symmetry, UPLO, target_partition, 0, 0,
                                       True, None, lib=ref_lib)
    key = lambda r: (int(r[2]), int(r[3]), int(r[4]), int(r[5]), bool(r[6]))
    return sorted(map(key, dense)), sorted(map(key, adm))


@pytest.mark.parametrize("symmetry,UPLO", [("N", "N"), ("S", "L"), ("H", "U")])
def test_block_plans_match(ref_lib, symmetry, UPLO):
    """The default block plan is the reference's native plan, and it has
    the python planner's leaf set, globally and for one partition."""
    tree = ht.ClusterTreeBuilder(max_leaf_size=35).build(create_sphere(900), n_partitions=2)
    kw = dict(epsilon=1e-4, eta=10.0, symmetry=symmetry, UPLO=UPLO)
    for part in (-1, 1):
        calls = native.bt_plan_native.calls
        plan = ht.plan_block_tree(tree, target_partition=part, **kw)
        assert native.bt_plan_native.calls == calls + 1
        assert _leafset(plan) == _ref_leafset(ref_lib, tree, symmetry, UPLO, part)
        assert _leafset(plan) == _leafset(
            ht.plan_block_tree(tree, target_partition=part, backend="python", **kw))
        assert len(plan.dense) > 0 and len(plan.admissible) > 0


def test_native_hmatrix_against_the_reference(ref_lib):
    """build_hmatrix on the default (native) tree and plan equals the JAX
    package's on the reference's native tree."""
    from htool_tpu.testing import laplace_kernel_symmetric as kj
    from htool_tpu_torch.convert import tree_from_numpy
    from htool_tpu_torch.testing import laplace_kernel_symmetric as kt
    from torch_parity import tree_fields

    pts = create_sphere(800, seed=4)
    tt = ht.build_cluster_tree(pts, max_leaf_size=32)
    tj = hj.ClusterTreeBuilder(max_leaf_size=32, backend="python").build(pts)
    tj_native = type(tj)(**{**tree_fields(tj), **{f: getattr(tt, f) for f in TREE_FIELDS},
                            "centers": tt.centers, "radii": tt.radii})
    _assert_same_tree(tree_from_numpy(tree_fields(tj_native)), tt)
    Hj = hj.build_hmatrix(hj.KernelGenerator(kj, pts, pts), tj_native, epsilon=1e-4, eta=10.0)
    Ht = ht.build_hmatrix(ht.KernelGenerator(kt, pts, pts), tt, epsilon=1e-4, eta=10.0)
    ij, it = hj.hmatrix_info(Hj), ht.hmatrix_info(Ht)
    for key in ("n_dense_blocks", "n_low_rank_blocks", "rank_max"):
        assert it[key] == ij[key], key
    assert np.abs(np.asarray(Hj.to_dense()) - Ht.to_dense()).max() < 1e-10


def test_backends_refuse_what_they_cannot_do(monkeypatch):
    pts = create_sphere(200)
    tree = ht.ClusterTreeBuilder(max_leaf_size=20).build(pts)
    with pytest.raises(ValueError, match="python planner"):
        ht.plan_block_tree(tree, backend="native", admissibility=lambda *a: False)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="native planner unavailable"):
        ht.ClusterTreeBuilder(max_leaf_size=20, backend="native").build(pts)
    with pytest.raises(RuntimeError, match="native planner unavailable"):
        ht.plan_block_tree(tree, backend="native")
    # "auto" falls back to the NumPy builders
    python = ht.ClusterTreeBuilder(max_leaf_size=20, backend="python").build(pts)
    _assert_same_tree(ht.ClusterTreeBuilder(max_leaf_size=20).build(pts), python)


def test_two_processes_build_into_one_directory(tmp_path):
    """Two processes compile the planner into the same empty directory at
    once: both succeed, both load the library, no temporary file is left."""
    code = ("import sys\n"
            "from htool_tpu_torch import native\n"
            "so = native.build_library(native.SOURCE, sys.argv[1])\n"
            "lib = native.load_library(so)\n"
            "print(so)\n")
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == str(tmp_path / "libplanner.so")
    assert sorted(os.listdir(tmp_path)) == ["libplanner.so"]
