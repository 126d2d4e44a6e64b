"""The PyTorch port imports without JAX and without the JAX package."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE = [
    "htool_tpu_torch",
    "htool_tpu_torch.utils.precision",
    "htool_tpu_torch.testing",
    "htool_tpu_torch.clustering.cluster_tree",
    "htool_tpu_torch.hmatrix.block_tree",
    "htool_tpu_torch.generator",
    "htool_tpu_torch.hmatrix.hmatrix",
    "htool_tpu_torch.hmatrix.aca",
    "htool_tpu_torch.hmatrix.assembly",
    "htool_tpu_torch.hmatrix.info",
    "htool_tpu_torch.ops.cut",
    "htool_tpu_torch.ops.tiled_matvec",
    "htool_tpu_torch.kernels",
    "htool_tpu_torch.hmatrix.linalg",
    "htool_tpu_torch.solvers.krylov",
    "htool_tpu_torch.solvers.ddm",
    "htool_tpu_torch.convert",
    "htool_tpu_torch.ops.bucket_matvec",
    "htool_tpu_torch.hmatrix.compressors",
    "htool_tpu_torch.hmatrix.lr_linalg",
    "htool_tpu_torch.hmatrix.output",
    "htool_tpu_torch.utils.device",
    "htool_tpu_torch.utils.logger",
    "htool_tpu_torch.utils.options",
    "htool_tpu_torch.testing.problems",
    "htool_tpu_torch.testing.geometry",
    "htool_tpu_torch.testing.kernels",
    "htool_tpu_torch.solvers.geneo",
    "htool_tpu_torch.native",
    "htool_tpu_torch.clustering.io",
    "htool_tpu_torch.testing.gmsh",
    "htool_tpu_torch.utils.profiling",
    "htool_tpu_torch.hmatrix.blr",
    "htool_tpu_torch.hmatrix.blr2",
    "htool_tpu_torch.hmatrix.conversion",
    "htool_tpu_torch.parallel",
    "htool_tpu_torch.parallel.collectives",
    "htool_tpu_torch.parallel.distributed",
    "htool_tpu_torch.parallel.info",
    "htool_tpu_torch.parallel.multihost",
    "htool_tpu_torch.solvers.dist_ddm",
]


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {SLICE!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'htool_tpu' or m.startswith(('htool_tpu.', 'jax.')))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_slice_lists_every_module_of_the_port():
    """SLICE, which the subprocess imports with jax blocked, misses no module."""
    import htool_tpu_torch

    found = {m.name for m in pkgutil.walk_packages(htool_tpu_torch.__path__, "htool_tpu_torch.")
             if not m.ispkg}
    assert found <= set(SLICE), sorted(found - set(SLICE))


def test_no_source_of_the_port_imports_jax():
    """No import statement of the port's package, of chip_smoke.py or of
    torch_bench.py, at any depth (function bodies included), names jax or
    the JAX package."""
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "torch_bench.py"),
             os.path.join(ROOT, "tests", "torch_multihost_worker.py")]
    files += [os.path.join(ROOT, "examples", n) for n in os.listdir(os.path.join(ROOT, "examples"))
              if n.startswith("torch_")]
    for base, _, names in os.walk(os.path.join(ROOT, "htool_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 25
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [(os.path.relpath(path, ROOT), m) for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "htool_tpu")]
    assert not bad, bad


def test_port_exports_slice_names():
    import htool_tpu
    import htool_tpu_torch

    slice_names = {
        "ClusterTree", "ClusterTreeBuilder", "build_cluster_tree", "Generator",
        "KernelGenerator", "MatrixGenerator", "BlockTreePlan", "plan_block_tree",
        "HMatrix", "DenseBucket", "LowRankBucket", "HMatrixBuilder", "build_hmatrix",
        "assemble_from_plan", "batched_partial_aca", "matvec", "matvec_user", "matmat",
        "matmat_user", "to_dense", "hmatrix_info", "print_hmatrix_information",
        "save_hmatrix", "load_hmatrix", "hmatrix_from_dense",
    }
    assert slice_names <= set(htool_tpu.__all__)
    assert slice_names <= set(htool_tpu_torch.__all__)
    for name in slice_names:
        assert hasattr(htool_tpu_torch, name), name
    # the GenEO coarse space, exported at the top as the JAX package's
    # solvers export it
    assert {"GeneoCoarseSpace", "build_geneo_coarse_space"} <= set(htool_tpu_torch.__all__)
    # block GMRES, the subset generator, the complex plans
    import htool_tpu.generator as gj
    import htool_tpu.ops.tiled_matvec as oj
    import htool_tpu.solvers.krylov as kj
    import htool_tpu_torch.generator as gt
    import htool_tpu_torch.ops.tiled_matvec as ot
    import htool_tpu_torch.solvers.krylov as kt

    for mj, mt, name in ((kj, kt, "block_gmres"), (gj, gt, "SubsetGenerator"),
                         (oj, ot, "build_tile_plan_complex")):
        assert hasattr(mj, name) and hasattr(mt, name), name
    # the subpackages' surface of the second slice
    import htool_tpu.hmatrix as hj
    import htool_tpu.testing as tj
    import htool_tpu.solvers as sj
    import htool_tpu.utils as uj
    import htool_tpu_torch.hmatrix as ht
    import htool_tpu_torch.testing as tt
    import htool_tpu_torch.solvers as st
    import htool_tpu_torch.utils as ut

    for mj, mt, names in (
        (hj, ht, ["copy_diagonal_user", "LowRank", "lrmat_from_dense", "lrmat_vector_product",
                  "lrmat_matrix_product", "matrix_lrmat_product", "lrmat_lrmat_product",
                  "add_lrmat_lrmat", "matrix_hmatrix_product", "hmatrix_lrmat_product",
                  "lrmat_hmatrix_product", "scale_lrmat", "batched_full_aca",
                  "batched_svd_compress", "batched_recompress", "svd_truncation_rank"]),
        (tj, tt, ["create_disk", "create_rotated_ellipse", "create_random_points",
                  "grid_laplacian"]),
        (uj, ut, ["Logger", "LogLevel", "logger", "SolverOptions", "Timer", "annotate",
                  "device_trace"]),
        (tj, tt, ["load_gmsh_nodes"]),
        (sj, st, ["GeneoCoarseSpace", "build_geneo_coarse_space"]),
    ):
        for name in names:
            assert hasattr(mj, name) and hasattr(mt, name), name


def test_port_exports_factorization_names():
    """The factorization layer's names, at the top as the JAX package
    exports them (``htool_tpu/__init__.py``) and in ``hmatrix``."""
    import htool_tpu
    import htool_tpu.hmatrix as hj
    import htool_tpu_torch
    import htool_tpu_torch.hmatrix as ht
    import htool_tpu_torch.convert as ct

    top = {"build_blr", "blr_lu", "blr_cholesky", "blr_solve", "build_blr2", "blr2_lu",
           "blr2_solve", "to_blr", "to_blr2", "lu_factorization", "lu_solve",
           "cholesky_factorization", "cholesky_solve", "hmatrix_hmatrix_product"}
    jax_top = set(htool_tpu.__all__) - {"to_device", "to_host"}  # utils/cxfer, not ported
    assert top | jax_top <= set(htool_tpu_torch.__all__)
    for name in top | jax_top:
        assert hasattr(htool_tpu_torch, name), name
    for name in ("BLRMatrix", "TwoLevelBLR", "blr_matmul", "blr_matvec", "blr2_backward_error",
                 "blr2_cholesky", "blr2_matvec", "recompress_hmatrix", "retile_blr",
                 "common_grid_blr"):
        assert hasattr(hj, name) and hasattr(ht, name), name
    assert hasattr(ct, "blr_from_numpy") and hasattr(ct, "blr2_from_numpy")


def test_port_exports_distributed_names():
    """The distributed layer's names, where the JAX package exports them
    (``htool_tpu/parallel/__init__.py``, ``htool_tpu/solvers/__init__.py``)."""
    import htool_tpu.parallel as pj
    import htool_tpu.solvers as sj
    import htool_tpu_torch.convert as ct
    import htool_tpu_torch.parallel as pt
    import htool_tpu_torch.solvers as st

    assert set(pj.__all__) <= set(pt.__all__)
    for name in pj.__all__:
        assert hasattr(pt, name), name
    for name in ("DistributedDDMSolver", "HaloExchange", "build_halo_exchange"):
        assert name in sj.__all__ and name in st.__all__ and hasattr(st, name), name
    assert hasattr(ct, "distributed_from_numpy")
