"""CG's static-state path (``solvers/krylov.py``: ``CGGraphs``) on the CPU.

CUDA graphs exist only on the card, so the tests open the private seam
``ddm._GRAPH_DEVICES``: on the CPU the "captured" segments are the body
itself, run again at each replay, through the same static state, copies in
and out, stopping tests and counters as on the card.  Checks: the seam gives
the eager loop's x, iterations and residual bit for bit, and the eager loop
gives today's loop's (``_reference_cg``, the loop before the static state,
kept here as the reference); an answer is not aliased by the next solve; a
new k, preconditioner or set of plans captures again; the distributed,
two-level, BLR-local, user-callable and GMRES solves stay eager with the
seam open; syncs and plain calls a solve equal the eager loop's; the counts
a capture takes back and a replay adds; spans are off while a stream
captures."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import htool_tpu_torch as ht
import torch_parity  # noqa: F401  (asks the port for the CPU)
from htool_tpu_torch.hmatrix.linalg import matvec, prepare_tiled_matvec
from htool_tpu_torch.ops.tiled_matvec import tiled_bucket_matvec
from htool_tpu_torch.parallel import build_distributed_hmatrix, default_mesh
from htool_tpu_torch.solvers import (
    DDMSolver,
    DistributedDDMSolver,
    build_geneo_coarse_space,
    build_geometric_overlap,
    ddm,
    dist_ddm,
)
from htool_tpu_torch.solvers.krylov import KrylovResult, _dots, _identity, _read, _rhs
from htool_tpu_torch.testing import create_sphere, laplace_kernel_symmetric
from htool_tpu_torch.utils import profiling
from htool_tpu_torch.utils.profiling import span

N = 1200
TOL = 1e-6


def _reference_cg(A, b, M=None, x0=None, tol=1e-6, maxiter=200, mesh=None):
    """CG's loop as it was before the static state: new tensors each step."""
    _vdot_cols, _norm_cols, _ = _dots(mesh)
    b, x, squeeze = _rhs(b, x0)
    M = M or _identity
    bnorm = _norm_cols(b)
    bnorm = torch.where(bnorm == 0, 1.0, bnorm)
    r = b - A(x)
    z = M(r)
    p = z
    rz = _vdot_cols(r, z)
    it = 0
    go = it < maxiter and _read(torch.any(_norm_cols(r) > tol * bnorm))
    while go:
        with span("htool.krylov.step"):
            Ap = A(p)
            pAp = _vdot_cols(p, Ap)
            alpha = rz / torch.where(pAp == 0, 1.0, pAp)
            active = _norm_cols(r) > tol * bnorm
            alpha = torch.where(active, alpha, 0.0)
            x = x + alpha[None, :] * p
            r = r - alpha[None, :] * Ap
            z = M(r)
            rz_new = _vdot_cols(r, z)
            beta = rz_new / torch.where(rz == 0, 1.0, rz)
            beta = torch.where(active, beta, 0.0)
            p = z + beta[None, :] * p
            rz = rz_new
            it += 1
            go = it < maxiter and _read(torch.any(_norm_cols(r) > tol * bnorm))
    res = _read(torch.max(_norm_cols(r) / bnorm))
    out = x[:, 0] if squeeze else x
    return KrylovResult(out, it, res, res <= tol)


@pytest.fixture(scope="module")
def problem():
    """The benchmark's problem at a small size: the sphere's symmetric
    operator with tiled plans, one-level ASM with overlap."""
    pts = create_sphere(N)
    P = torch.as_tensor(pts)
    gen = ht.KernelGenerator(laplace_kernel_symmetric, P, P)
    tree = ht.build_cluster_tree(pts, max_leaf_size=64, n_partitions=8)
    H = ht.build_hmatrix(gen, tree, epsilon=1e-3, eta=100.0, symmetry="S", UPLO="L")
    prepare_tiled_matvec(H)
    overlap = build_geometric_overlap(tree, 0.1)
    return dict(gen=gen, tree=tree, H=H, overlap=overlap,
                solver=DDMSolver(H, gen, tree, schwarz="asm", overlap=overlap))


@pytest.fixture
def seam(monkeypatch):
    monkeypatch.setattr(ddm, "_GRAPH_DEVICES", ("cuda", "cpu"))


def _rhs_of(k, seed=0):
    b = np.random.RandomState(seed).randn(N, k)
    return b[:, 0] if k == 1 else b


def _solve(solver, b, **kw):
    """(x, infos, change of every process counter) of one CG solve."""
    before = profiling.counters()
    x, infos = solver.solve(b, krylov="cg", tol=TOL, **kw)
    after = profiling.counters()
    return x, infos, {k: n - before.get(k, 0) for k, n in after.items()}


def _reference_in(monkeypatch, module):
    """``module.cg`` replaced by today's loop (the private keyword dropped)."""
    monkeypatch.setattr(module, "cg", lambda *a, _graphs=None, **kw: _reference_cg(*a, **kw))


@pytest.mark.parametrize("k", [1, 4])
def test_seam_gives_the_eager_loops_bits(problem, monkeypatch, k):
    solver = problem["solver"]
    b = _rhs_of(k)
    x_e, inf_e, c_e = _solve(solver, b)  # eager: the seam is closed
    assert c_e.get("krylov_graph_steps", 0) == 0
    with monkeypatch.context() as m:
        _reference_in(m, ddm)
        x_r, inf_r, _ = _solve(solver, b)
    assert torch.equal(x_e, x_r) and inf_e["Nb_it"] == inf_r["Nb_it"]
    assert inf_e["Residual"] == inf_r["Residual"]
    monkeypatch.setattr(ddm, "_GRAPH_DEVICES", ("cuda", "cpu"))
    for _ in range(2):  # the capturing solve, then a replay of the captured one
        x_g, inf_g, c_g = _solve(solver, b)
        assert torch.equal(x_g, x_e) and inf_g["Nb_it"] == inf_e["Nb_it"] > 0
        assert inf_g["Residual"] == inf_e["Residual"] and inf_g["Converged"]
        assert c_g["krylov_graph_steps"] == inf_g["Nb_it"]
    # after the capture a solve makes the eager loop's syncs and plain calls
    assert c_g["syncs"] == c_e["syncs"] and c_g["plain_calls"] == c_e["plain_calls"]
    assert c_g.get("krylov_graph_captures", 0) == 0


def test_seam_without_a_preconditioner(problem, monkeypatch):
    """No apply segment: z is r itself, in the eager loop and in the seam."""
    g = problem
    solver = DDMSolver(g["H"], g["gen"], g["tree"], schwarz="none")
    b = _rhs_of(1, seed=5)
    with monkeypatch.context() as m:
        _reference_in(m, ddm)
        x_r, inf_r, _ = _solve(solver, b)
    x_e, inf_e, _ = _solve(solver, b)
    monkeypatch.setattr(ddm, "_GRAPH_DEVICES", ("cuda", "cpu"))
    x_g, inf_g, c_g = _solve(solver, b)
    assert torch.equal(x_g, x_e) and torch.equal(x_e, x_r)
    assert inf_g["Nb_it"] == inf_e["Nb_it"] == inf_r["Nb_it"] > 0
    assert inf_g["Residual"] == inf_e["Residual"] == inf_r["Residual"]
    assert c_g["krylov_graph_steps"] == inf_g["Nb_it"]


def test_an_answer_is_not_the_static_state(problem, seam):
    solver = problem["solver"]
    x1, _, _ = _solve(solver, _rhs_of(1, seed=1))
    kept = x1.clone()
    x2, _, _ = _solve(solver, _rhs_of(1, seed=2))
    assert torch.equal(x1, kept) and not torch.equal(x1, x2)
    x0 = torch.as_tensor(_rhs_of(1, seed=3))
    x0_kept = x0.clone()
    _solve(solver, _rhs_of(1, seed=2), x0=x0[torch.as_tensor(solver.tree.permutation)])
    assert torch.equal(x0, x0_kept)


def test_what_the_graphs_read_changes_captures_again(problem, seam):
    g, solver = problem, problem["solver"]
    s = DDMSolver(g["H"], g["gen"], g["tree"], schwarz="asm", overlap=g["overlap"])
    want = _solve(s, _rhs_of(1))[0]
    assert _solve(s, _rhs_of(1))[2].get("krylov_graph_captures", 0) == 0  # captured above
    assert _solve(s, _rhs_of(4))[2]["krylov_graph_captures"] == 1  # another k
    assert _solve(s, _rhs_of(4))[2]["krylov_graph_captures"] == 0
    s.precond = DDMSolver(g["H"], g["gen"], g["tree"], schwarz="ras",
                          overlap=g["overlap"]).precond  # another preconditioner
    x, infos, c = _solve(s, _rhs_of(1))
    assert c["krylov_graph_captures"] == 1
    s.precond = solver.precond
    assert torch.equal(_solve(s, _rhs_of(1))[0], want)
    H2 = ht.build_hmatrix(g["gen"], g["tree"], epsilon=1e-3, eta=100.0, symmetry="S", UPLO="L")
    s2 = DDMSolver(H2, g["gen"], g["tree"], schwarz="asm", overlap=g["overlap"])
    _solve(s2, _rhs_of(1))  # unplanned products
    prepare_tiled_matvec(H2)  # new plans
    x, _, c = _solve(s2, _rhs_of(1))
    assert c["krylov_graph_captures"] == 1 and torch.equal(x, want)


def test_a_new_pair_plan_captures_again(problem, seam):
    """The graphs read each mirror bucket's pair plan (``bucket.pair``):
    replacing one bucket's pair plan by a new one captures again, with the
    same answer; the products of a replayed step count their pairs."""
    from htool_tpu_torch.ops.pair_matvec import PairPlan, build_pair_plan

    g = problem
    s = DDMSolver(g["H"], g["gen"], g["tree"], schwarz="asm", overlap=g["overlap"])
    want, infos, _ = _solve(s, _rhs_of(1, seed=6))
    x, _, c = _solve(s, _rhs_of(1, seed=6))
    n_pair = sum(isinstance(b.pair, PairPlan) for b in g["H"].lr_buckets + g["H"].dense_buckets)
    assert n_pair >= 2 and c.get("krylov_graph_captures", 0) == 0 and torch.equal(x, want)
    assert c["product_pairs_fused"] == n_pair * (infos["Nb_it"] + 1)
    b = next(b for b in g["H"].lr_buckets if isinstance(b.pair, PairPlan))
    old = b.pair
    b.pair = build_pair_plan(b, old.out_len)
    try:
        x, _, c = _solve(s, _rhs_of(1, seed=6))
        assert c["krylov_graph_captures"] == 1 and torch.equal(x, want)
    finally:
        b.pair = old


def _callable_solver(g):
    H = g["H"]
    return DDMSolver(lambda v: matvec(H, v), g["gen"], g["tree"], schwarz="asm",
                     overlap=g["overlap"])


def _two_level_solver(g):
    H = g["H"]
    cs = build_geneo_coarse_space(g["gen"], g["tree"], g["overlap"], lambda v: matvec(H, v), nu=2)
    return DDMSolver(H, g["gen"], g["tree"], schwarz="asm", overlap=g["overlap"], coarse=cs)


def _blr_solver(g):
    return DDMSolver(g["H"], g["gen"], g["tree"], schwarz="asm", overlap=g["overlap"],
                     local_solver="blr", blr_epsilon=1e-8, blr_block_size=64)


def _distributed_solver(g):
    mesh = default_mesh(g["tree"].n_partitions, device="cpu")
    dop = build_distributed_hmatrix(g["gen"], g["tree"], mesh, epsilon=1e-3, eta=100.0)
    return DistributedDDMSolver(dop, g["gen"], g["tree"], schwarz="asm", overlap=g["overlap"])


@pytest.mark.parametrize("path, module, krylov", [
    ("callable", ddm, "cg"), ("two_level", ddm, "cg"), ("blr", ddm, "cg"),
    ("distributed", dist_ddm, "cg"), ("gmres", ddm, "gmres")])
def test_other_paths_stay_eager(problem, seam, monkeypatch, path, module, krylov):
    """With the seam open these solves replay nothing and give today's
    loop's bits."""
    make = {"callable": _callable_solver, "two_level": _two_level_solver, "blr": _blr_solver,
            "distributed": _distributed_solver, "gmres": lambda g: g["solver"]}[path]
    solver = make(problem)
    b = _rhs_of(1, seed=4)
    before = profiling.counters()
    x, infos = solver.solve(b, krylov=krylov, tol=TOL, maxiter=100)
    after = profiling.counters()
    assert infos["Nb_it"] > 0
    for name in ("krylov_graph_steps", "krylov_graph_captures"):
        assert after.get(name, 0) == before.get(name, 0), name
    if krylov == "cg":
        with monkeypatch.context() as m:
            _reference_in(m, module)
            x_r, infos_r = solver.solve(b, krylov=krylov, tol=TOL, maxiter=100)
        assert torch.equal(x, x_r) and infos["Nb_it"] == infos_r["Nb_it"]
        assert infos["Residual"] == infos_r["Residual"]


def test_tallies_are_taken_back_and_added():
    before = profiling.tallies()
    delta = {(None, "htool.test_tally"): 3, (tiled_bucket_matvec, "cuda_launches"): 2,
             (tiled_bucket_matvec, "launches_by_k", (torch.float32, 7)): 5}
    profiling.add_tallies(delta)
    after = profiling.tallies()
    assert {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)} == delta
    profiling.add_tallies(delta, -1)
    back = profiling.tallies()
    assert {k: n for k, n in back.items() if n != before.get(k, 0)} == {}
    del profiling._counters["htool.test_tally"], tiled_bucket_matvec.launches_by_k[
        (torch.float32, 7)]


def test_spans_are_off_while_a_stream_captures(monkeypatch):
    profiling.clear()
    monkeypatch.setattr(profiling, "_capturing", lambda: True)
    with torch.profiler.profile():
        with profiling.span("htool.captured", device=torch.device("cpu")):
            pass
    assert profiling.span("htool.x") is profiling.span("htool.y")
    assert profiling.spans() == []
