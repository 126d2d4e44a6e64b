"""The system under test for configurations with ``"program": "ddm_solver"``:
the calls into ``htool_tpu_torch``.

It builds a problem through the public entry points (tree, assembly, tiled
product plans, Schwarz preconditioner) and solves with ``DDMSolver.solve``.
Every setting comes from the configuration's groups, passed on as keyword
arguments: ``tree`` to ``build_cluster_tree``, ``hmatrix`` to
``build_hmatrix``, ``solver`` to ``DDMSolver`` and ``solve`` to its
``solve``; ``tiled_matvec`` says whether ``prepare_tiled_matvec`` runs.  A
span is recorded around each layer it calls.
"""

from __future__ import annotations

import numpy as np
import torch


class Problem:
    """One geometry's points, operator and solver."""

    def __init__(self, points: torch.Tensor, H, solver):
        self.points = points
        self.H = H
        self.solver = solver


class Program:
    """``build`` a problem from float32 points, ``solve`` it, apply its
    operator (``product``, the public ``H @ x``)."""

    def __init__(self, cfg: dict, kernel, device: torch.device):
        import htool_tpu_torch  # noqa: F401  (pins full-precision matmuls at import)

        self.cfg = cfg
        self.kernel = kernel
        self.device = device
        self.dtype = getattr(torch, cfg["dtype"])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def build(self, points32: np.ndarray, spans) -> Problem:
        import htool_tpu_torch as ht
        from htool_tpu_torch.hmatrix.linalg import prepare_tiled_matvec
        from htool_tpu_torch.solvers import DDMSolver

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
            H = ht.build_hmatrix(gen, tree, **cfg["hmatrix"])
            if cfg["tiled_matvec"]:
                prepare_tiled_matvec(H)
        with spans.span("schwarz_setup", self.sync):
            solver = DDMSolver(H, gen, tree, **cfg["solver"])
        return Problem(pts_d, H, solver)

    def solve(self, problem: Problem, B: torch.Tensor, spans):
        """(X, iterations, converged): one ``DDMSolver.solve`` of B [n, c];
        a single column is passed as a vector, as a caller with one
        right-hand side passes it."""
        with spans.span("solve", self.sync):
            b = B[:, 0] if B.shape[1] == 1 else B
            x, infos = problem.solver.solve(b, **self.cfg["solve"])
        X = x[:, None] if x.ndim == 1 else x
        return X, int(infos["Nb_it"]), bool(infos["Converged"])

    def product(self, problem: Problem, X: torch.Tensor) -> torch.Tensor:
        return problem.H @ X

    def operator(self, problem: Problem):
        return problem.H
