"""``torch_multichip.py`` — the distributed operator and the Schwarz + GMRES
solve over several processes of the port — against the JAX package on its
emulated device mesh, and the rule that gives each rank its card.

``torch_multichip.py --device cpu`` starts W ranks (gloo, a file store, no
JAX) that each build only their partitions of the sphere's operator
(n = 1,200, float64, leaf 256, ε = 1e-3, η = 10), apply g2g N and T at
k = 8 and solve with RAS (overlap 0.02, dense local LU) + GMRES(60) to
1e-6.  The JAX package builds the same operator with
``build_distributed_hmatrix`` on ``default_mesh(4)`` (4 emulated devices)
and solves with its ``DistributedDDMSolver``.  The workers' tree must be
the JAX package's (permutation and partition offsets); the gathered
products must agree to rel 1e-12, the iteration counts must be equal and
the solutions agree to rel 1e-8, for 4 ranks of one partition each and for
2 ranks of two.  A run whose rank overruns its time limit must fail in
bounded time."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import htool_tpu as hj  # noqa: E402
import htool_tpu.solvers.dist_ddm as dj  # noqa: E402
from htool_tpu.parallel import build_distributed_hmatrix as j_build_distributed  # noqa: E402
from htool_tpu.parallel import default_mesh as j_default_mesh  # noqa: E402
from htool_tpu.testing import create_sphere, laplace_kernel_symmetric  # noqa: E402
import torch_parity  # noqa: E402,F401  (the port on the CPU)
from htool_tpu_torch.parallel import initialize_multihost, rank_device  # noqa: E402
from htool_tpu_torch.parallel import multihost  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "torch_multichip.py")
N, NP, SEED = 1200, 4, 0
RUNS = {"world4": (4, 4), "world2": (2, 4)}  # (ranks, partitions)


def _start(world, partitions, out, n=N, timeout=240):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    return subprocess.Popen(
        [sys.executable, SCRIPT, "--world", str(world), "--partitions", str(partitions),
         "--device", "cpu", "--dtype", "float64", "--n", str(n), "--seed", str(SEED),
         "--timeout", str(timeout), "--out", str(out)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runs of the script, started together, and the JAX package's
    reference computed while they run."""
    outs = {name: tmp_path_factory.mktemp(name) for name in RUNS}
    procs = {name: _start(w, p, outs[name]) for name, (w, p) in RUNS.items()}
    try:
        pts = create_sphere(N, seed=SEED)
        tree = hj.build_cluster_tree(pts, max_leaf_size=256, n_partitions=NP)
        gen = hj.KernelGenerator(laplace_kernel_symmetric, pts, pts)
        D = j_build_distributed(gen, tree, j_default_mesh(NP), epsilon=1e-3, eta=10.0)
        x = np.random.RandomState(SEED).randn(N, 8)
        b = np.random.RandomState(SEED + 1).randn(N)
        s = dj.DistributedDDMSolver(D, gen, tree, schwarz="ras", overlap_radius=0.02,
                                    local_solver="dense")
        xs, infos = s.solve(b, tol=1e-6, krylov="gmres", restart=60, maxiter=200)
        ref = dict(y_N=np.asarray(D.matvec(x, op="N")), y_T=np.asarray(D.matvec(x, op="T")),
                   x=np.asarray(xs), iterations=infos["Nb_it"],
                   permutation=np.asarray(tree.permutation),
                   part_offsets=np.asarray(tree.partition_offsets_sizes()[0]))
        results = {}
        for name, p in procs.items():
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"{name}: {err[-3000:]}"
            with open(outs[name] / "summary.json") as f:
                results[name] = dict(np.load(outs[name] / "gathered.npz"), summary=json.load(f))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return ref, results


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("name", list(RUNS))
def test_ranks_match_the_jax_distributed_solve(runs, name):
    ref, results = runs
    got = results[name]
    # the workers built the port's tree: it must be the JAX package's
    np.testing.assert_array_equal(got["permutation"], ref["permutation"])
    np.testing.assert_array_equal(got["part_offsets"], ref["part_offsets"])
    for key in ("y_N", "y_T"):
        assert _rel(got[key], ref[key]) <= 1e-12, (key, _rel(got[key], ref[key]))
    assert _rel(got["x"], ref["x"]) <= 1e-8, _rel(got["x"], ref["x"])


@pytest.mark.parametrize("name", list(RUNS))
def test_ranks_take_the_jax_iteration_count(runs, name):
    ref, results = runs
    summary = results[name]["summary"]
    world, partitions = RUNS[name]
    assert summary["world"] == world and summary["partitions"] == partitions
    assert summary["backend"] == "gloo" and summary["cards"] == ["cpu"] * world
    assert summary["iterations"] == [ref["iterations"]] * world
    assert summary["residual_max"] < 10 * 1e-6
    for rank in summary["ranks"]:
        p_local = partitions // world
        assert rank["lu_shape"][0] == p_local and rank["n_ext_max"] < N
        assert rank["local_partitions"] == [rank["rank"] * p_local, (rank["rank"] + 1) * p_local]
        assert rank["tensors_on_card"]


def test_a_rank_over_its_time_limit_fails_the_run(tmp_path):
    """Ranks that cannot finish within ``--timeout`` are killed, and the run
    exits nonzero within seconds of the limit."""
    t0 = time.monotonic()
    p = _start(2, 2, tmp_path, n=20_000, timeout=1)
    try:
        out, err = p.communicate(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 1
    assert "overran its time limit of 1 s" in out + err
    assert time.monotonic() - t0 < 60


# ---------------------------------------------------------------- the card of a rank


@pytest.mark.parametrize("local_rank", range(4))
def test_launcher_rank_takes_its_card(local_rank):
    env = {"LOCAL_RANK": str(local_rank)}
    for backend in ("nccl", "gloo"):
        assert rank_device(torch.device("cuda"), backend, env, 4) == torch.device(
            "cuda", local_rank)


def test_single_process_takes_card_zero():
    for env in ({}, {"LOCAL_RANK": ""}):
        assert rank_device(torch.device("cuda"), "nccl", env, 4) == torch.device("cuda", 0)


def test_explicit_devices_are_kept():
    env = {"LOCAL_RANK": "3"}
    assert rank_device(torch.device("cuda", 1), "nccl", env, 2) == torch.device("cuda", 1)
    assert rank_device(torch.device("cpu"), "gloo", env, 0) == torch.device("cpu")


def test_nccl_with_more_ranks_than_cards_raises():
    with pytest.raises(RuntimeError, match=r"LOCAL_RANK=4.* 4 CUDA device\(s\): NCCL takes "
                                           "one rank a card"):
        rank_device(torch.device("cuda"), "nccl", {"LOCAL_RANK": "4"}, 4)


@pytest.mark.parametrize("cards", [1, 2])
def test_gloo_ranks_share_the_cards(cards):
    got = [rank_device(torch.device("cuda"), "gloo", {"LOCAL_RANK": str(r)}, cards)
           for r in range(4)]
    assert got == [torch.device("cuda", r % cards) for r in range(4)]


def test_initialize_raises_before_the_group_starts(monkeypatch):
    """Under NCCL, a LOCAL_RANK beyond the cards raises in
    ``initialize_multihost`` before it touches a card or starts the group."""
    touched = []
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(multihost.torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(multihost.torch.cuda, "set_device", lambda d: touched.append(d))
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda *a, **kw: touched.append("init_process_group"))
    with pytest.raises(RuntimeError, match="LOCAL_RANK=1"):
        initialize_multihost("file:///nonexistent/store", 2, 1, device="cuda")
    assert touched == []


def test_distributed_operator_example_under_a_launcher(tmp_path):
    """``examples/torch_use_distributed_operator.py`` under ``torchrun`` (two
    ranks on the CPU over gloo): each rank holds half the partitions, and its
    l2l and g2g products agree.  Each rank's output goes to a file of its own
    (``--log-dir``, ``--redirects 3``), so the two ranks' lines never
    interleave in one pipe."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
         "--log-dir", str(tmp_path), "--redirects", "3",
         os.path.join(ROOT, "examples", "torch_use_distributed_operator.py"), "--device", "cpu",
         "--n", "1500"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
    logs = sorted(tmp_path.rglob("stdout.log"))
    stdout = [p.read_text() for p in logs]
    stderr = "".join(p.read_text() for p in tmp_path.rglob("stderr.log"))
    assert out.returncode == 0, (out.stderr + stderr)[-3000:]
    assert len(stdout) == 2, logs
    for text in stdout:
        assert text.count("l2l == g2g: True") == 1, text[-3000:]
        assert text.count("n_partitions                 4") == 1, text[-3000:]


def test_ppermute_starts_an_nccl_group_with_a_collective(tmp_path, monkeypatch):
    """On an NCCL group, the first ``ppermute`` of a mesh runs one all_reduce
    over the group before any P2P batch, also on a rank that has no pair
    crossing ranks (here every pair stays inside the one rank), and later
    calls do not.  The group is gloo of world size 1 with its backend read
    as NCCL's."""
    from htool_tpu_torch.parallel import collectives as C

    dist = torch.distributed
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        mesh = C.Mesh(4, "cpu", group=dist.group.WORLD)
        calls = []
        monkeypatch.setattr(C.dist, "get_backend", lambda group=None: "nccl")
        monkeypatch.setattr(C.dist, "all_reduce", lambda t, group=None: calls.append(t.numel()))
        x = torch.arange(8.0).reshape(4, 2)
        pairs = [(p, (p + 1) % 4) for p in range(4)]
        for _ in range(3):
            np.testing.assert_array_equal(C.ppermute(x, pairs, mesh).numpy(),
                                          x.roll(1, dims=0).numpy())
        assert calls == [1]
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()
