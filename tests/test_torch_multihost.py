"""Two processes of the port wired by ``torch.distributed`` — the
``mpiexec -np 2`` analog of ``tests/test_multihost.py``.

Each process (``tests/torch_multihost_worker.py``, which imports no JAX)
holds 2 of P = 4 partitions on the CPU; gloo carries the collectives over a
file store in ``tmp_path``.  The g2g N and T products, the l2l products and
one RAS + GMRES solve must equal this process's single-process run of the
same operator (rel 1e-12, the same iteration count), and a complex
``ppermute`` and a ``psum_scatter`` across the ranks must deliver what the
single-process collectives do.  The workers are killed when they overrun
their time limit, so a hang fails in bounded time."""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import torch_parity  # noqa: F401  (the port on the CPU)
import htool_tpu_torch as ht
from htool_tpu_torch.parallel import build_distributed_hmatrix, default_mesh
from htool_tpu_torch.parallel.collectives import Mesh, ppermute, psum_scatter
from htool_tpu_torch.solvers import DistributedDDMSolver
from htool_tpu_torch.testing import create_sphere, laplace_kernel_symmetric

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD, NP = 2, 4


def test_two_process_gloo_matches_one_process(tmp_path):
    worker = os.path.join(HERE, "torch_multihost_worker.py")
    store = tmp_path / "store"
    procs = [subprocess.Popen([sys.executable, worker, str(r), str(WORLD), str(store), str(NP),
                               str(tmp_path / f"worker{r}.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            logs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail("a multihost worker overran its time limit")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    res = [dict(np.load(tmp_path / f"worker{r}.npz")) for r in range(WORLD)]
    assert [int(r["lo"]) for r in res] == [0, NP // WORLD]
    assert all(int(r["world"]) == WORLD for r in res)

    # the same operator, solve and collectives in this one process
    n = 480
    pts = create_sphere(n)
    gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts, dtype=torch.float64)
    tree = ht.build_cluster_tree(pts, max_leaf_size=40, n_partitions=NP)
    D = build_distributed_hmatrix(gen, tree, default_mesh(NP), epsilon=1e-6, eta=10.0)
    x = np.random.RandomState(0).randn(n, 2)
    xc = x[tree.permutation]
    want = dict(y_N=D.matvec(x, op="N").numpy(), y_T=D.matvec(x, op="T").numpy())
    for op in ("N", "T"):
        want[f"l2l_{op}"] = D.to_global_layout(
            D.matvec_local(D.to_local_layout(xc), op=op)).numpy()
    xs, infos = DistributedDDMSolver(D, gen, tree, schwarz="ras", overlap_radius=0.3).solve(
        want["y_N"][:, 0], tol=1e-8, krylov="gmres")
    for r in res:
        for key, v in want.items():
            np.testing.assert_allclose(r[key], v, rtol=1e-12, atol=1e-12 * np.abs(v).max(),
                                       err_msg=key)
        assert int(r["iterations"]) == infos["Nb_it"]
        np.testing.assert_allclose(r["x_solve"], xs.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(xs.abs().max()))

    mesh = Mesh(NP, "cpu")
    # the workers' inputs: partition p of rank r holds 3·(p - lo) + 10·lo + (0, 1, 2)
    z = torch.stack([torch.arange(3, dtype=torch.float64) + 3 * (p % 2) + 10 * (p - p % 2)
                     for p in range(NP)]) * (1 + 2j)
    perm_want = ppermute(z, [(p, (p + 1) % NP) for p in range(NP)], mesh).numpy()
    ps_want = psum_scatter(torch.ones((NP, 2 * NP, 2), dtype=torch.float64)
                           * torch.tensor([1.0, 1.0, 3.0, 3.0])[:, None, None], mesh).numpy()
    for r, lo in zip(res, (0, NP // WORLD)):
        np.testing.assert_array_equal(r["ppermute"], perm_want[lo : lo + NP // WORLD])
        np.testing.assert_array_equal(r["psum_scatter"], ps_want[lo : lo + NP // WORLD])
