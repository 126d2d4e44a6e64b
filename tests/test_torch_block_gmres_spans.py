"""Block GMRES's spans and its rank counter on the CPU: under a profiler
each block step records one ``htool.krylov.orth`` (block Gram-Schmidt and
block QR) and one ``htool.krylov.lstsq`` (the least squares of the stopping
test) as its children, a cycle's closing least squares lies outside any
step, and the solve's root span carries the count of blocks that lost rank;
without a profiler the sites record nothing and change nothing."""

import pytest

torch = pytest.importorskip("torch")

import htool_tpu_torch as ht
import torch_parity  # noqa: F401  (asks the port for the CPU)
from htool_tpu_torch.hmatrix.linalg import prepare_tiled_matvec
from htool_tpu_torch.solvers import DDMSolver
from htool_tpu_torch.utils import profiling
from test_torch_block_gmres_rank import TOL, make_sphere


@pytest.fixture(scope="module")
def problem():
    """The complex block solve of ``test_torch_block_gmres_rank.py``: its
    blocks lose rank in complex64 before the solve converges."""
    s = make_sphere()
    H = ht.build_hmatrix(s["gen"], s["tree"], epsilon=1e-3, eta=100.0, symmetry="S", UPLO="L")
    prepare_tiled_matvec(H)
    return DDMSolver(H, s["gen"], s["tree"], schwarz="asm", overlap_radius=0.1), s["B"]


def _solve(problem, restart=50):
    solver, B = problem
    return solver.solve(B, tol=TOL, maxiter=200, krylov="block_gmres", restart=restart)


@pytest.mark.parametrize("restart", [50, 3], ids=["one_cycle", "restarted"])
def test_spans_of_a_block_step(problem, restart):
    profiling.clear()
    with torch.profiler.profile():
        x, infos = _solve(problem, restart)
    recs = profiling.spans()
    profiling.clear()
    assert infos["Converged"]
    by_id = {r["id"]: r for r in recs}
    steps = [r for r in recs if r["name"] == "htool.krylov.step"]
    assert len(steps) == infos["Nb_it"]
    for name in ("htool.krylov.orth", "htool.krylov.lstsq"):
        inside = [r for r in recs if r["name"] == name and r["parent"] in by_id
                  and by_id[r["parent"]]["name"] == "htool.krylov.step"]
        # one a step, nested in it, timed on the device that does the work
        assert sorted(r["parent"] for r in inside) == sorted(r["id"] for r in steps)
        assert all(r["device_us"] > 0 for r in inside)
        for r in inside:
            step = by_id[r["parent"]]
            assert step["t0"] <= r["t0"] <= r["t1"] <= step["t1"]
    cycles = -(-infos["Nb_it"] // restart)
    closing = [r for r in recs if r["name"] == "htool.krylov.lstsq"
               and by_id[r["parent"]]["name"] == "htool.ddm.solve"]
    assert len(closing) == cycles  # a cycle's solve for Y, outside any step
    assert all(r["name"] != "htool.krylov.orth" or by_id[r["parent"]]["name"] == "htool.krylov.step"
               for r in recs)
    root = [r for r in recs if r["name"] == "htool.ddm.solve"]
    assert len(root) == 1
    # the blocks that lost rank in complex64: at least one, at most one a QR
    # (each step's and each cycle's start)
    assert 1 <= root[0]["counters"]["krylov_block_rank_deficient"] <= infos["Nb_it"] + cycles
    # the tally rides on the last read: a stopping test a step and one a
    # cycle's start (none after a cycle's m-th step), a cycle's residual, the
    # last read
    full = infos["Nb_it"] // restart
    assert root[0]["counters"]["syncs"] == infos["Nb_it"] + 2 * cycles + 1 - full


def test_off_records_nothing_and_changes_nothing(problem):
    """Without a profiler the new sites are the shared no-op context and
    record nothing; under one the solve returns the same bits."""
    profiling.clear()
    x_off, infos_off = _solve(problem)
    assert profiling.spans() == [] and profiling.dropped() == 0
    assert profiling.span("htool.krylov.orth", device=x_off) is profiling.span(
        "htool.krylov.lstsq", device=x_off)
    with torch.profiler.profile():
        x_on, infos_on = _solve(problem)
    profiling.clear()
    assert torch.equal(x_off, x_on) and infos_off["Nb_it"] == infos_on["Nb_it"]
