"""The port's H-matrix outputs and persistence against the JAX package, and
the small copied modules (logger, solver options, test geometries and
problems)."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

import htool_tpu as hj
import htool_tpu.hmatrix.output as oj
import htool_tpu.testing as kj
import htool_tpu_torch as ht
from htool_tpu_torch.ops.tiled_matvec import SplitPlan
import htool_tpu_torch.hmatrix.output as ot
import htool_tpu_torch.testing as kt
from htool_tpu.testing import create_sphere, laplace_kernel_symmetric
from htool_tpu_torch.convert import hmatrix_from_numpy
from htool_tpu_torch.hmatrix.linalg import matvec, prepare_tiled_matvec
from torch_parity import hmatrix_to_numpy

N = 600


@pytest.fixture(scope="module")
def pairs():
    out = {}
    pts = create_sphere(N)
    tree = hj.ClusterTreeBuilder(max_leaf_size=32, backend="python").build(pts)
    gen = hj.KernelGenerator(laplace_kernel_symmetric, pts, pts)
    for sym, uplo in (("N", "N"), ("S", "L")):
        Hj = hj.build_hmatrix(gen, tree, epsilon=1e-4, eta=10.0, symmetry=sym, UPLO=uplo)
        out[sym] = (Hj, hmatrix_from_numpy(hmatrix_to_numpy(Hj)))
    return out


def _same_hmatrix(a, b):
    assert (a.shape, a.symmetry, a.UPLO, a.t_root_off) == (b.shape, b.symmetry, b.UPLO, b.t_root_off)
    assert torch.equal(a.perm_t, b.perm_t) and torch.equal(a.perm_s, b.perm_s)
    for ba, bb in zip(a.dense_buckets + a.lr_buckets, b.dense_buckets + b.lr_buckets):
        for f in dataclasses.fields(ba):
            va, vb = getattr(ba, f.name), getattr(bb, f.name)
            if f.name.startswith("plan_"):
                assert (va is None) == (vb is None)
            elif isinstance(va, torch.Tensor):
                assert va.dtype == vb.dtype and torch.equal(va, vb), f.name
            else:
                np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(a.to_dense(), b.to_dense())


@pytest.mark.parametrize("plans", [False, True])
@pytest.mark.parametrize("sym", ["N", "S"])
def test_save_load_roundtrip(pairs, tmp_path, sym, plans):
    """The port's npz round trip keeps every bucket field and, when the
    H-matrix has tiled plans, the plans: the reloaded products are equal."""
    _, Ht = pairs[sym]
    H = hmatrix_from_numpy(hmatrix_to_numpy(pairs[sym][0]))
    if plans:
        prepare_tiled_matvec(H, tile_rows=128)
    path = str(tmp_path / "h.npz")
    ht.save_hmatrix(H, path)
    H2 = ht.load_hmatrix(path)
    _same_hmatrix(H, H2)
    for b, b2 in zip(H.dense_buckets + H.lr_buckets, H2.dense_buckets + H2.lr_buckets):
        for side in ("t", "s"):
            p, p2 = getattr(b, f"plan_{side}"), getattr(b2, f"plan_{side}")
            if plans:
                assert type(p2) is type(p)
                if isinstance(p, SplitPlan):  # its two stages, over the bucket's own U and V
                    assert p2.r_pad == p.r_pad
                    assert {id(p2.stage_a.data), id(p2.stage_b.data)} == {id(b2.U), id(b2.V)}
                    stages = list(zip(p, p2))
                else:
                    assert p2.data is b2.data if p2.kind == "dense" else p2.U is b2.U
                    stages = [(p, p2)]
                for q, q2 in stages:
                    for f in dataclasses.fields(q):
                        va, vb = getattr(q, f.name), getattr(q2, f.name)
                        assert torch.equal(va, vb) if isinstance(va, torch.Tensor) else va == vb
    x = torch.as_tensor(np.random.RandomState(1).randn(N, 2))
    for op in ("N", "T"):
        np.testing.assert_array_equal(matvec(H2, x, op=op).numpy(), matvec(H, x, op=op).numpy())
    # the JAX package reads the port's file (its plans are skipped)
    Hj2 = oj.load_hmatrix(path)
    np.testing.assert_array_equal(np.asarray(Hj2.to_dense()), H.to_dense())


@pytest.mark.parametrize("sym", ["N", "S"])
def test_load_jax_written_npz(pairs, tmp_path, sym):
    """A file the JAX package wrote (include_plans=False) loads into the
    same H-matrix as the one carried across in memory."""
    Hj, Ht = pairs[sym]
    path = str(tmp_path / "hj.npz")
    oj.save_hmatrix(Hj, path, include_plans=False)
    _same_hmatrix(ot.load_hmatrix(path), Ht)


@pytest.mark.parametrize("writer", ["save_leaves_with_rank", "save_levels", "view_block_tree"])
def test_structure_files_equal_jax(pairs, tmp_path, writer):
    Hj, Ht = pairs["S"]
    pj, pt = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    getattr(oj, writer)(Hj, pj)
    getattr(ot, writer)(Ht, pt)
    with open(pj) as fj, open(pt) as ft:
        assert ft.read() == fj.read()


@pytest.mark.parametrize("shape", ["create_disk", "create_rotated_ellipse",
                                   "create_random_points", "grid_laplacian"])
def test_testing_fixtures_equal_jax(shape):
    kwargs = {"create_rotated_ellipse": dict(angle=0.3), "grid_laplacian": {}}.get(shape, {})
    args = () if shape == "grid_laplacian" else (97,)
    a, b = getattr(kj, shape)(*args, **kwargs), getattr(kt, shape)(*args, **kwargs)
    for x, y in zip(*(v if isinstance(v, tuple) else (v,) for v in (a, b))):
        np.testing.assert_array_equal(x, y)


def test_logger_and_options_equal_jax():
    from htool_tpu.utils import SolverOptions as Oj
    from htool_tpu.utils import logger as lj
    from htool_tpu_torch.utils import LogLevel, Logger, SolverOptions, logger

    argv = "-hpddm_krylov_method cg -hpddm_tol 1e-8 -hpddm_max_it 55 schwarz_method asm"
    assert dataclasses.asdict(SolverOptions.parse(argv)) == dataclasses.asdict(Oj.parse(argv))
    assert SolverOptions.parse(argv).solve_kwargs() == Oj.parse(argv).solve_kwargs()
    with pytest.raises(ValueError):
        SolverOptions(krylov_method="bicg")
    assert logger is Logger.get_instance() and logger.level == lj.level == LogLevel.ERROR
    seen = []
    logger.set_writer(lambda level, msg: seen.append((level, msg)))
    try:
        logger.info("hidden")
        logger.error("shown")
    finally:
        logger.set_writer(Logger._default_writer)
    assert seen == [(LogLevel.ERROR, "shown")]
