"""One geometry, its operator and preconditioner built in set-up; a unit is
one ``solve`` of a new block of ``nrhs`` right-hand sides, each the
potential of its own source."""

from __future__ import annotations

import torch

from harness import inputs
from harness.inputs import GEOMETRY, WINDOW
from harness.loops import CheckInputs
from harness.loops import Loop as Base


class Loop(Base):
    kind = "solve_stream"

    def setup(self) -> None:
        pts = inputs.sphere_points(self.n, self.seed, GEOMETRY)
        self.problem = self.side.build(pts, self.spans)

    def unit(self, stream: int, k: int) -> dict:
        with self.spans.span("rhs"):
            B = self.rhs(self.problem.points, stream, k)
        X, iterations, converged = self.side.solve(self.problem, B, self.spans)
        if stream == WINDOW:
            self.keep((k, X))
        return dict(iterations=iterations, converged=converged)

    def collect(self) -> CheckInputs:
        pts = self.problem.points
        B = torch.cat([self.rhs(pts, WINDOW, k) for k, _ in self.sample], dim=1)
        X = torch.cat([x for _, x in self.sample], dim=1)
        return CheckInputs([(pts, B, X)], self._product_rows(self.problem, X))

    def probe(self):
        """(problem, x): the operator the window drove and a block of
        right-hand sides for the product probe of a traced run."""
        return self.problem, self.rhs(self.problem.points, inputs.TRACE, 0)

    def release(self) -> None:
        self.problem = None
        self.sample = []
