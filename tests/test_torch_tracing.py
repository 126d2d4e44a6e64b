"""The port's spans and counters (``utils/profiling.py``) on the CPU: off
without a profiler, the same spans as the profiler's trace with one, the
self-time arithmetic, the ``syncs`` count of CG, the launch and plain-call
deltas of a root span, and the bound on the buffer."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import htool_tpu_torch as ht
import torch_parity  # noqa: F401  (asks the port for the CPU)
from htool_tpu_torch.hmatrix.linalg import matvec, prepare_tiled_matvec
from htool_tpu_torch.ops.pair_matvec import PairPlan
from htool_tpu_torch.ops.tiled_matvec import tiled_bucket_matvec
from htool_tpu_torch.solvers import DDMSolver
from htool_tpu_torch.solvers.krylov import cg
from htool_tpu_torch.testing import create_sphere, laplace_kernel_symmetric
from htool_tpu_torch.utils import annotate, device_trace, profiling

N = 1200
NAMES = {"htool.assembly.aca", "htool.schwarz.overlap", "htool.schwarz.local", "htool.ddm.solve",
         "htool.krylov.step", "htool.krylov.wait", "htool.hmatrix.product",
         "htool.schwarz.apply"}
STEP_CHILDREN = ("htool.hmatrix.product", "htool.schwarz.apply", "htool.krylov.wait")


def _build():
    """The benchmark's problem at a small size: the sphere's symmetric
    operator with tiled plans and one-level ASM with overlap."""
    pts = create_sphere(N)
    P = torch.as_tensor(pts)
    gen = ht.KernelGenerator(laplace_kernel_symmetric, P, P)
    tree = ht.build_cluster_tree(pts, max_leaf_size=64, n_partitions=8)
    H = ht.build_hmatrix(gen, tree, epsilon=1e-3, eta=100.0, symmetry="S", UPLO="L")
    prepare_tiled_matvec(H)
    return H, DDMSolver(H, gen, tree, schwarz="asm", overlap_radius=0.1)


@pytest.fixture(scope="module")
def problem():
    return _build()


def _rhs(seed=0):
    return np.random.RandomState(seed).randn(N)


def test_off_records_nothing_and_changes_nothing(problem):
    """Without a profiler a solve records no span; under one it returns the
    same bits."""
    _, solver = problem
    profiling.clear()
    x_off, infos_off = solver.solve(_rhs(), krylov="cg", tol=1e-6)
    assert profiling.spans() == [] and profiling.dropped() == 0
    assert profiling.span("htool.ddm.solve") is profiling.span("htool.krylov.step")
    with torch.profiler.profile():
        x_on, infos_on = solver.solve(_rhs(), krylov="cg", tol=1e-6)
    assert torch.equal(x_off, x_on) and infos_off["Nb_it"] == infos_on["Nb_it"]
    assert {r["name"] for r in profiling.spans()} == NAMES - {
        "htool.assembly.aca", "htool.schwarz.overlap", "htool.schwarz.local"}
    profiling.clear()
    assert profiling.spans() == []


def _complete(events, name):
    return sorted((e for e in events if e.get("ph") == "X" and e.get("name") == name
                   and e.get("cat") == "user_annotation"), key=lambda e: e["ts"])


def test_spans_are_the_traces_annotations(tmp_path):
    """Under ``device_trace`` every span is a ``user_annotation`` event of
    the trace with the same name, count and nesting; the spans of one solve
    share its root."""
    profiling.clear()
    with device_trace(str(tmp_path / "trace")):
        H, solver = _build()
        x, infos = solver.solve(_rhs(1), krylov="cg", tol=1e-6)
    recs = profiling.spans()
    assert {r["name"] for r in recs} == NAMES
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    by_id = {}
    for name in NAMES:
        mine = [r for r in recs if r["name"] == name]
        theirs = _complete(events, name)
        assert len(mine) == len(theirs), name
        by_id.update((r["id"], e) for r, e in zip(mine, theirs))
    for r in recs:
        if r["parent"] is not None:
            e, p = by_id[r["id"]], by_id[r["parent"]]
            assert p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"], r["name"]
    solve = [r for r in recs if r["name"] == "htool.ddm.solve"]
    assert len(solve) == 1 and solve[0]["root"] == solve[0]["id"] and solve[0]["parent"] is None
    inside = [r for r in recs if solve[0]["t0"] <= r["t0"] <= solve[0]["t1"]]
    assert len(inside) > 1 and {r["root"] for r in inside} == {solve[0]["id"]}
    steps = [r for r in inside if r["name"] == "htool.krylov.step"]
    assert len(steps) == infos["Nb_it"]
    assert {r["parent"] for r in steps} == {solve[0]["id"]}
    # one ACA, one overlap and one local build a problem, each a root of its own
    for name in ("htool.assembly.aca", "htool.schwarz.overlap", "htool.schwarz.local"):
        (r,) = [r for r in recs if r["name"] == name]
        assert r["root"] == r["id"] and r["t1"] > r["t0"]
    assert H.info["aca_walltime"] > 0
    # on the CPU the apply's device time is its own duration
    for r in recs:
        if r["name"] == "htool.schwarz.apply":
            assert r["device_us"] == (r["t1"] - r["t0"]) / 1e3
    profiling.clear()


def _rec(name, i, parent, t0, t1):
    return {"name": name, "id": i, "parent": parent, "root": 1, "t0": t0, "t1": t1}


def test_self_times_on_synthetic_records():
    recs = [
        _rec("htool.ddm.solve", 1, None, 0, 1000),
        _rec("htool.krylov.step", 2, 1, 10, 410),
        _rec("htool.hmatrix.product", 3, 2, 20, 120),
        _rec("htool.schwarz.apply", 4, 2, 130, 180),
        _rec("htool.hmatrix.product", 5, 4, 140, 170),  # inside the apply: not the step's child
        _rec("htool.krylov.wait", 6, 2, 300, 400),
        _rec("htool.krylov.step", 7, 1, 500, 600),
        _rec("htool.krylov.wait", 8, 1, 650, 700),  # the solve's, not a step's
    ]
    assert profiling.self_times(recs, "htool.krylov.step", STEP_CHILDREN) == [150, 100]
    assert profiling.self_times(recs, "htool.krylov.step") == [400, 100]
    assert profiling.self_times(recs, "htool.ddm.solve", ("htool.krylov.step",)) == [500]
    assert profiling.self_times(recs, "htool.none", STEP_CHILDREN) == []


@pytest.mark.parametrize("maxiter", [200, 3])
def test_cg_syncs(problem, maxiter):
    """CG reads one stopping test an iteration, one more to stop when it
    converges first, and the final residual; ``DDMSolver.solve`` adds its
    closing sync on a CUDA device only."""
    H, solver = problem
    before = profiling.counters().get("syncs", 0)
    b = torch.as_tensor(_rhs(2))[torch.as_tensor(solver.tree.permutation)]  # cluster numbering
    res = cg(lambda v: matvec(H, v), b, M=solver.precond.apply, tol=1e-6, maxiter=maxiter)
    n = profiling.counters()["syncs"] - before
    tests = res.iterations + 1 if res.iterations < maxiter else maxiter
    assert n == tests + 1
    assert res.converged == (maxiter == 200)
    profiling.clear()
    with torch.profiler.profile():
        _, infos = solver.solve(_rhs(2), krylov="cg", tol=1e-6, maxiter=maxiter)
    (root,) = [r for r in profiling.spans() if r["name"] == "htool.ddm.solve"]
    assert root["counters"]["syncs"] == tests + 1 and infos["Nb_it"] == res.iterations
    waits = [r for r in profiling.spans() if r["name"] == "htool.krylov.wait"]
    assert len(waits) == tests + 1
    profiling.clear()


def test_root_counts_launches_and_plain_calls(problem, monkeypatch):
    """A root span holds the change of the wrappers' CUDA launches and of
    every process counter across it: on the CPU each bucket term of each
    product is one plain call, a mirror bucket's two terms one call where
    they run as a pair."""
    H, solver = problem
    pairs = sum(isinstance(b.pair, PairPlan) for b in H.dense_buckets + H.lr_buckets)
    terms = sum(1 + int(b.mirror) for b in H.dense_buckets + H.lr_buckets) - pairs
    profiling.clear()
    products = matvec.products
    with torch.profiler.profile():
        _, infos = solver.solve(_rhs(3), krylov="cg", tol=1e-6)
        with profiling.span("htool.test"):
            monkeypatch.setattr(tiled_bucket_matvec, "cuda_launches",
                                tiled_bucket_matvec.cuda_launches + 7)
    products = matvec.products - products
    assert products == infos["Nb_it"] + 1  # the first residual's, then one a step
    solve, other = [r for r in profiling.spans() if r["parent"] is None]
    assert solve["counters"]["plain_calls"] == terms * products
    assert solve["counters"].get("product_pairs_fused", 0) == pairs * products
    assert solve["counters"]["launches"] == 0
    assert other["counters"]["launches"] == 7 and other["counters"]["plain_calls"] == 0
    profiling.clear()


def test_buffer_bound(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    profiling.clear()
    with torch.profiler.profile():
        with profiling.span("htool.outer"):
            for _ in range(7):
                with profiling.span("htool.inner"):
                    pass
    recs = profiling.spans()
    assert len(recs) == 5 and profiling.dropped() == 3
    assert [r["name"] for r in recs] == ["htool.outer"] + ["htool.inner"] * 4
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_annotate_is_a_span():
    profiling.clear()
    with annotate("htool.off"):
        pass
    assert profiling.spans() == []
    with torch.profiler.profile() as prof:
        with annotate("htool.on"):
            torch.ones(8) @ torch.ones(8)
    assert [r["name"] for r in profiling.spans()] == ["htool.on"]
    assert "htool.on" in {e.key for e in prof.key_averages()}
    profiling.clear()


def test_sync_ends_a_span_only_when_on(monkeypatch):
    """``sync=`` synchronizes when the span is on and not when it is off."""
    seen = []
    monkeypatch.setattr(profiling, "_synchronize", seen.append)
    x = torch.ones(3)
    with profiling.span("htool.off", sync=x):
        pass
    assert seen == []
    with torch.profiler.profile():
        with profiling.span("htool.on", sync=x):
            pass
    assert seen == [x]
    profiling.clear()
