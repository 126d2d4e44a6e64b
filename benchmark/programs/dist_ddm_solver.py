"""The system under test for configurations with ``"program": "dist_ddm_solver"``:
the port's distributed operator and solver, one rank a card.

Every rank builds the whole cluster tree, its share of the partitions'
block rows (``build_distributed_hmatrix`` over ``global_mesh``: P
partitions spread evenly over the ranks of the process group) and the
distributed Schwarz preconditioner (``DistributedDDMSolver``); a solve
passes the whole right-hand side and returns the whole solution on every
rank.  Without a process group (a cell on one card) the mesh holds all P
partitions on this process's device.  Every setting comes from the
configuration's groups, passed on as keyword arguments: ``tree`` to
``build_cluster_tree``, ``hmatrix`` to ``build_distributed_hmatrix``,
``solver`` to ``DistributedDDMSolver`` and ``solve`` to its ``solve``.  The
block rows run the unplanned product kernels (the port plans no distributed
product), so ``tiled_matvec`` must be false.  The spans are those of
``ddm_solver.py``, whose ``solve``, ``product`` and ``operator`` this
adapter keeps: the product is the global-to-global ``H @ x`` of the
distributed operator, the operator this rank's block rows (bucket size
arrays ``[P_local, nb]``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from harness.spec import _load_module

_one_process = _load_module(Path(__file__).with_name("ddm_solver.py"), "bench_program")
Problem = _one_process.Problem


class Program(_one_process.Program):
    """``build`` this rank's share of a problem from float32 points."""

    def __init__(self, cfg: dict, kernel, device: torch.device):
        if cfg.get("tiled_matvec"):
            raise ValueError("the distributed operator has no planned product: "
                             "a dist_ddm_solver configuration states tiled_matvec false")
        super().__init__(cfg, kernel, device)

    def _mesh(self, n_partitions: int):
        from htool_tpu_torch.parallel import default_mesh, global_mesh

        if torch.distributed.is_initialized():
            return global_mesh(n_partitions, device=self.device)
        return default_mesh(n_partitions, device=self.device)

    def build(self, points32: np.ndarray, spans) -> Problem:
        import htool_tpu_torch as ht
        from htool_tpu_torch.parallel import build_distributed_hmatrix
        from htool_tpu_torch.solvers import DistributedDDMSolver

        cfg = self.cfg
        with spans.span("points"):
            pts_d = torch.as_tensor(points32, device=self.device)
        with spans.span("tree"):
            tree = ht.build_cluster_tree(points32.astype(np.float64), **cfg["tree"])
        with spans.span("assembly", self.sync):
            gen = ht.KernelGenerator(self.kernel, pts_d, pts_d)
            if gen.dtype != self.dtype:
                raise ValueError(f"the kernel gives {gen.dtype} on float32 points, "
                                 f"the configuration states {self.dtype}")
            dop = build_distributed_hmatrix(gen, tree, self._mesh(tree.n_partitions),
                                            **cfg["hmatrix"])
        with spans.span("schwarz_setup", self.sync):
            solver = DistributedDDMSolver(dop, gen, tree, **cfg["solver"])
        return Problem(pts_d, dop, solver)
