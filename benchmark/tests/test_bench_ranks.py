"""A cell on several cards, on the CPU: two gloo ranks go through the
launcher's functions (``harness.ranks``; ``run.py`` itself refuses to run
without CUDA) on a throwaway two-rank copy of the tiny sphere
(``conftest.TINY``) with the ``dist_ddm_solver`` program, written as files
in a temporary root.  The run is correct and prints one result line, from
rank 0; its answers equal a one-process run's; a rank that raises or hangs
ends the run with no result and no process left; a cell on one card starts
no process and no process group."""

import io
import json
import os
import sys
import time

import pytest
import torch

from harness import ranks, runner
from harness.spec import Spec

from conftest import ROOT, TINY, add_cell, copy_benchmark, shrink

SEED = 2**33 + 29
WORLD = 2

# a rank of the launch on the CPU: what run.py's rank branch does, on gloo
CHILD = """import json, os, sys
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, "benchmark"), {repo!r}]
os.makedirs(os.path.join(HERE, "pids"), exist_ok=True)
with open(os.path.join(HERE, "pids", f"{{os.getpid()}}"), "w"):
    pass
import htool_tpu_torch as ht
ht.set_default_device("cpu")
from harness import ranks, runner
from harness.spec import Spec
if sys.argv[1] == "gather":  # the peaks given on the command line, one a rank
    from htool_tpu_torch.parallel import shutdown_multihost
    r, _, _ = ranks.join("cpu")
    given = [None if v == "none" else int(v) for v in sys.argv[2:]]
    print(json.dumps({{"largest": r.largest(given[r.rank]), "gathered": r.gather(given[r.rank])}}))
    shutdown_multihost()
else:
    result = ranks.run_rank(Spec(HERE), sys.argv[1], int(sys.argv[2]), float(sys.argv[3]),
                            bool(int(sys.argv[4])), "cpu")
    if result is not None:
        runner.emit(result)
"""

# the program under test, with what the tests read: each solve's answer and
# iterations, and the operator's bytes and bucket shapes, a file a rank; a
# configuration's "fault" makes rank 1 raise or hang in build
PROGRAM = """import os, time
from pathlib import Path
import torch
from harness import roofline
from harness.spec import _load_module
Base = _load_module(Path(__file__).with_name("dist_ddm_solver.py"), "dist").Program


class Program(Base):
    def __init__(self, cfg, kernel, device):
        super().__init__(cfg, kernel, device)
        self.rank = os.environ.get("RANK", "solo")
        self.seen = dict(solves=[])
        self.path = Path(__file__).parents[2] / "seen" / f"{self.rank}.pt"
        self.path.parent.mkdir(exist_ok=True)

    def build(self, points32, spans):
        if self.rank == "1" and self.cfg.get("fault") == "raise":
            raise RuntimeError("rank 1 fails in build")
        while self.rank == "1" and self.cfg.get("fault") == "hang":
            time.sleep(1)
        problem = super().build(points32, spans)
        dop = self.operator(problem)
        self.seen.update(bytes=roofline.product_bytes(dop, 1), n_local=dop.mesh.n_local,
                         shapes=[list(b.t_sizes.shape) for b in dop.dense_buckets + dop.lr_buckets])
        return problem

    def solve(self, problem, B, spans):
        X, iterations, converged = super().solve(problem, B, spans)
        self.seen["solves"].append((iterations, X.clone()))
        torch.save(self.seen, self.path)
        return X, iterations, converged
"""


@pytest.fixture(scope="module")
def dist_root(tmp_path_factory):
    """A copy of the benchmark with the throwaway cells ``dist2_stream``,
    ``dist2_raise`` and ``dist2_hang`` (two cards each) and the rank script."""
    root = copy_benchmark(tmp_path_factory.mktemp("ranks"))
    base = json.loads((root / "benchmark/configs/sphere_laplace_f32_n100k.json").read_text())
    (root / "benchmark/programs/rank_probe.py").write_text(PROGRAM)
    (root / "rank_child.py").write_text(CHILD.format(repo=str(ROOT)))
    for tag, fault in (("stream", None), ("raise", "raise"), ("hang", "hang")):
        cfg = dict(shrink(base, TINY), name=f"tiny_dist2_{tag}", program="rank_probe",
                   tiled_matvec=False, fault=fault)
        add_cell(root, cfg, f"dist2_{tag}", WORLD)
    return root


def launch(root, args, timeout=120.0, workdir=None):
    """(exit code, standard output, standard error, seconds) of a launch of
    the rank script as two ranks."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    code = ranks.parent([sys.executable, str(root / "rank_child.py"), *map(str, args)], WORLD,
                        timeout, t0, "cpu", workdir=workdir, out=out, err=err)
    return code, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def json_lines(text):
    lines = []
    for line in text.splitlines():
        try:
            lines.append(json.loads(line))
        except ValueError:
            pass
    return lines


def no_process_left(root):
    for name in os.listdir(root / "pids"):
        with pytest.raises(ProcessLookupError):
            os.kill(int(name), 0)
        os.unlink(root / "pids" / name)


@pytest.fixture(scope="module")
def two_ranks(dist_root, tmp_path_factory):
    """The two-rank run of ``dist2_stream``, its work directory kept."""
    work = tmp_path_factory.mktemp("work")
    return launch(dist_root, ["dist2_stream", SEED, 0.5, 1], workdir=str(work)) + (work,)


def test_two_ranks_are_correct_with_one_result_line(dist_root, two_ranks):
    code, out, err, _, work = two_ranks
    assert code == 0, err[-4000:]
    (r,) = json_lines(out)
    assert json.loads(out.strip().splitlines()[-1]) == r
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert r["device"] == dict(r["device"], platform="cpu", count=WORLD, memory_peak_bytes=None)
    assert r["device"]["busy_s"] >= 0 and r["device"]["window_s"] > 0 and "breakdown" in r
    assert r["metrics"]["iterations.solve"]["value"] >= 1
    assert (work / "rank1.out").read_text() == ""  # rank 1 prints no result
    assert err.rstrip().splitlines()[-1].startswith("check unconverged")
    assert "window flag:" in err and "peak_bytes by rank [None, None]" in err
    no_process_left(dist_root)


def test_answers_equal_one_process(dist_root, two_ranks):
    """Rank by rank the answers and iterations of the two-rank run equal a
    one-process run of the same configuration (all partitions on one
    device, no process group), and each rank's block rows are its half of
    the partitions: bucket sizes [P_local, nb], bytes that add up to the
    one-process operator's."""
    code, out, err, _, _ = two_ranks
    assert code == 0, err[-4000:]
    (r,) = json_lines(out)
    import htool_tpu_torch  # noqa: F401

    solo = runner.run(Spec(dist_root), "dist2_stream", SEED, 0.3, False, torch.device("cpu"),
                      time.perf_counter())
    assert solo["correct"] and solo["device"]["count"] == 1
    seen = {k: torch.load(dist_root / "seen" / f"{k}.pt") for k in ("0", "1", "solo")}
    n = TINY["n"]
    xy = 4 * (n + n)  # x read and y written once, at k = 1 in float32
    P = TINY["tree"]["n_partitions"]
    for rank in ("0", "1"):
        assert seen[rank]["n_local"] == P // WORLD
        assert all(s[0] == P // WORLD for s in seen[rank]["shapes"])
        common = 1 + min(r["attempted"], solo["attempted"])  # the warm-up and the window's
        for (it, x), (it1, x1) in zip(seen[rank]["solves"][:common], seen["solo"]["solves"]):
            assert it == it1
            assert float((x - x1).abs().max() / x1.abs().max()) <= 1e-6
    assert seen["solo"]["n_local"] == P
    assert seen["0"]["bytes"] + seen["1"]["bytes"] - 2 * xy == seen["solo"]["bytes"] - xy


def test_peak_is_the_largest_of_the_ranks(dist_root):
    code, out, err, _ = launch(dist_root, ["gather", 3_000_000_000, 7_000_000_000])
    assert code == 0, err[-4000:]
    assert json_lines(out) == [{"largest": 7_000_000_000,
                                "gathered": [3_000_000_000, 7_000_000_000]}]
    assert "peak_bytes by rank [3000000000, 7000000000]" in err
    code, out, err, _ = launch(dist_root, ["gather", 5, "none"])
    assert code == 0 and json_lines(out) == [{"largest": 5, "gathered": [5, None]}]
    no_process_left(dist_root)


def test_a_rank_that_raises_ends_the_run(dist_root):
    code, out, err, _ = launch(dist_root, ["dist2_raise", SEED, 0.5, 0])
    assert code != 0 and out == ""
    assert "rank 1: exit code 1" in err and "rank 1 fails in build" in err
    no_process_left(dist_root)


def test_a_rank_that_hangs_is_killed_at_the_time_limit(dist_root):
    limit = 12.0
    code, out, err, seconds = launch(dist_root, ["dist2_hang", SEED, 0.5, 0], timeout=limit)
    assert code != 0 and out == ""
    assert f"overran the time limit of {limit:g} s" in err
    assert limit <= seconds < limit + 10
    no_process_left(dist_root)


def test_the_time_limit_follows_the_window():
    assert ranks.time_limit(51) == 51 + ranks.SETUP_ALLOWANCE_S
    assert ranks.time_limit(1) < ranks.time_limit(51) <= 360 - 30


def test_a_cell_on_one_card_starts_no_process_and_no_group(monkeypatch, capsys):
    """``run.py`` on a one-card cell calls the runner once, in this process,
    without ranks, and nothing else: no child process, no process group."""
    import subprocess

    import run

    for var in ("HTOOL_TPU_TORCH_KERNEL_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(var, os.environ.get(var, ""))
    monkeypatch.delenv(ranks.LAUNCH, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    calls = []

    def fake_run(spec, cell, seed, seconds, trace, device, t_start, **kw):
        calls.append((cell, device, kw))
        return {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
                "device": {"count": 1}, "checks": {}}

    def refused(*a, **kw):
        raise AssertionError("a one-card cell started a process or a process group")

    monkeypatch.setattr(runner, "run", fake_run)
    monkeypatch.setattr(subprocess, "Popen", refused)
    monkeypatch.setattr(torch.distributed, "init_process_group", refused)
    code = run.main(["--workload", "real_solve_stream", "--seed", "1", "--seconds", "1",
                     "--trace", "0"])
    assert code == 0
    assert calls == [("real_solve_stream", torch.device("cuda", 0), {})]
    assert not torch.distributed.is_initialized()
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["device"]["count"] == 1
