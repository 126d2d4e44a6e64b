"""Worker process of ``tests/test_torch_multihost.py``: one of several
processes wired by ``torch.distributed`` (gloo, a file store) that each hold
an even share of P partitions on the CPU.  It builds the distributed
operator on the global mesh, applies it (g2g N and T) and runs one RAS +
GMRES solve, ends the group with ``shutdown_multihost`` while the mesh, the
operator and the solver are still alive, and writes its results as NumPy
arrays, with whether the group was freed and the process's thread count
before and after.  It imports no JAX.

Usage: python torch_multihost_worker.py <rank> <world_size> <store_file> <n_partitions> <out.npz>
"""

import os
import sys
import weakref

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import htool_tpu_torch as ht  # noqa: E402
from htool_tpu_torch.parallel import (  # noqa: E402
    build_distributed_hmatrix,
    global_mesh,
    initialize_multihost,
    is_multihost,
    shutdown_multihost,
)
from htool_tpu_torch.parallel.collectives import ppermute, psum_scatter  # noqa: E402
from htool_tpu_torch.solvers import DistributedDDMSolver  # noqa: E402
from htool_tpu_torch.testing import create_sphere, laplace_kernel_symmetric  # noqa: E402

rank, world, store, P, out_path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                   int(sys.argv[4]), sys.argv[5])
torch.set_num_threads(1)
ht.set_default_device("cpu")
initialize_multihost(f"file://{store}", world, rank)
assert is_multihost() and torch.distributed.get_backend() == "gloo"

mesh = global_mesh(P)
assert (mesh.world_size, mesh.n_local) == (world, P // world)
n = 480
pts = create_sphere(n)
gen = ht.KernelGenerator(laplace_kernel_symmetric, pts, pts, dtype=torch.float64)
tree = ht.build_cluster_tree(pts, max_leaf_size=40, n_partitions=P)
D = build_distributed_hmatrix(gen, tree, mesh, epsilon=1e-6, eta=10.0)
x = np.random.RandomState(0).randn(n, 2)
res = dict(y_N=D.matvec(x, op="N").numpy(), y_T=D.matvec(x, op="T").numpy())
xc = x[tree.permutation]
for op in ("N", "T"):  # l2l: this rank's slices only, gathered back
    res[f"l2l_{op}"] = D.to_global_layout(D.matvec_local(D.to_local_layout(xc), op=op)).numpy()
# a complex ppermute across the ranks: partition p sends to p + 1 (mod P)
z = torch.arange(mesh.n_local * 3, dtype=torch.float64).reshape(mesh.n_local, 3) + 10 * mesh.lo
z = z * (1 + 2j)
res["ppermute"] = ppermute(z, [(p, (p + 1) % P) for p in range(P)], mesh).numpy()
res["psum_scatter"] = psum_scatter(torch.ones((mesh.n_local, 2 * P, 2), dtype=torch.float64)
                                   * (1 + mesh.lo), mesh).numpy()
s = DistributedDDMSolver(D, gen, tree, schwarz="ras", overlap_radius=0.3)
xs, infos = s.solve(res["y_N"][:, 0], tol=1e-8, krylov="gmres")
res.update(x_solve=xs.numpy(), iterations=np.array(infos["Nb_it"]),
           lo=np.array(mesh.lo), world=np.array(torch.distributed.get_world_size()))
# the group must be freed, and its threads stopped, by the shutdown itself,
# not at interpreter exit when the globals holding the mesh are collected
group = weakref.ref(mesh.group)
res["threads_before_shutdown"] = np.array(len(os.listdir("/proc/self/task")))
shutdown_multihost()
res["threads_after_shutdown"] = np.array(len(os.listdir("/proc/self/task")))
res["group_freed"] = np.array(group() is None)
np.savez(out_path, **res)
print("WORKER_OK", rank, flush=True)
