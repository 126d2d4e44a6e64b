"""A unit is a whole problem: a new point cloud, tree, assembly, product
plans, Schwarz set-up and one solve of ``nrhs`` right-hand sides."""

from __future__ import annotations

import torch

from harness import inputs
from harness.inputs import WINDOW
from harness.loops import CheckInputs
from harness.loops import Loop as Base


class Loop(Base):
    kind = "new_problem"

    def setup(self) -> None:
        self.last = None

    def unit(self, stream: int, k: int) -> dict:
        self.last = None  # the previous problem is freed before the next is built
        with self.spans.span("inputs"):
            pts = inputs.sphere_points(self.n, self.seed, stream, k)
        problem = self.side.build(pts, self.spans)
        with self.spans.span("rhs"):
            B = self.rhs(problem.points, stream, k)
        X, iterations, converged = self.side.solve(problem, B, self.spans)
        if stream == WINDOW:
            self.keep((k, pts, X))
            self.last = (k, problem, X)
        return dict(iterations=iterations, converged=converged)

    def collect(self) -> CheckInputs:
        groups = []
        k_last, problem, X_last = self.last
        for k, pts, X in self.sample:
            if k != k_last:
                p = torch.as_tensor(pts, device=X.device)
                groups.append((p, self.rhs(p, WINDOW, k), X))
        groups.append((problem.points, self.rhs(problem.points, WINDOW, k_last), X_last))
        return CheckInputs(groups, self._product_rows(problem, X_last))

    def probe(self):
        """None: no operator outlives a problem."""
        return None

    def release(self) -> None:
        self.last = None
        self.sample = []
