"""What every kind of traffic shares.  A traffic mix (``traffic/<mix>.json``)
names its kind, and the kind's loop is ``kinds/<kind>.py``, a class
``Loop`` built on the one here with ``setup``, ``unit``, ``collect``,
``probe`` and ``release``.  The harness finds it by that name.

The kinds are closed loops with one caller: a unit starts when the one before
it has returned.  Unit k of a stream takes its points and sources from
(seed, stream, k) (``inputs``).  The answers kept for the check are a
uniform sample of the window's units, drawn from the seed (reservoir
sampling, so the memory held does not grow with the window).
"""

from __future__ import annotations

import numpy as np
import torch

from . import inputs
from .inputs import ROWS, SAMPLE

# columns of the sampled answers that the product check applies the operator to
PRODUCT_COLUMNS = 16


class CheckInputs:
    """What the comparison needs, the program's part already computed:
    ``groups`` of (points, B, X) that share a geometry, and the product
    check's (points, rows, X, rows of the program's H @ X)."""

    def __init__(self, groups, product):
        self.groups = groups
        self.product = product


class Loop:
    """The base of a kind's loop; ``kind`` is the kind's name."""

    kind = ""

    def __init__(self, side, cfg: dict, mix: dict, seed: int, spans):
        self.side = side
        self.mix = mix
        self.seed = seed
        self.spans = spans
        self.n = int(cfg["n"])
        self.nrhs = int(mix["nrhs"])
        self._pick = inputs.rng(seed, SAMPLE)
        self.sample: list = []
        self._seen = 0

    def rhs(self, points: torch.Tensor, stream: int, k: int) -> torch.Tensor:
        src, phase = inputs.sources(self.nrhs, self.mix["source_radius"], self.seed, stream, k)
        return inputs.rhs(points, src, phase, self.side.dtype)

    def keep(self, item) -> None:
        """Reservoir sampling of ``check_units`` window units."""
        size = int(self.mix["check_units"])
        if len(self.sample) < size:
            self.sample.append(item)
        else:
            j = int(self._pick.integers(0, self._seen + 1))
            if j < size:
                self.sample[j] = item
        self._seen += 1

    def _product_rows(self, problem, X):
        """The product check's inputs: ``check_rows`` rows drawn from the
        seed, and those rows of the program's ``H @ x`` on sampled answers."""
        rows = inputs.rng(self.seed, ROWS).choice(self.n, min(self.n, int(self.mix["check_rows"])),
                                                  replace=False)
        rows = torch.as_tensor(np.sort(rows), device=X.device)
        Xp = X[:, :PRODUCT_COLUMNS]
        Y = self.side.product(problem, Xp)
        return (problem.points, rows, Xp, Y[rows])
