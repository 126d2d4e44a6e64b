"""Inputs made from the run's seed: point clouds, sources, right-hand sides.

Every draw takes a NumPy generator seeded with ``(seed, stream, k)``, so solve
or problem k of a run can be rebuilt from the seed alone, and the streams of
the window, the warm-up and the traced stretch never share an input.  Points
are drawn on the host (the planners build the tree there) and rounded to
float32 once; the program and the reference are both handed those rounded
values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the streams of one seed
GEOMETRY, WINDOW, WARMUP, TRACE, SAMPLE, ROWS = range(6)

_SEED_MASK = (1 << 64) - 1


def rng(seed: int, *keys: int) -> np.random.Generator:
    """A generator for (seed, keys): any whole seed, negative or wider than
    32 bits, maps to one non-negative entropy word."""
    return np.random.default_rng([int(seed) & _SEED_MASK, *keys])


def sphere_points(n: int, seed: int, *keys: int) -> np.ndarray:
    """n uniform points on the unit sphere, float32 [n, 3] (the method of
    ``htool_tpu_torch.testing.create_sphere``, drawn from the given keys)."""
    u, v = rng(seed, *keys).random((2, n))
    theta = 2.0 * np.pi * u
    phi = np.arccos(np.clip(2.0 * v - 1.0, -1.0, 1.0))
    pts = np.stack([np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)],
                   axis=1)
    return pts.astype(np.float32)


def sources(count: int, radius: float, seed: int, *keys: int) -> tuple[np.ndarray, np.ndarray]:
    """``count`` point sources uniform on the sphere of ``radius`` and a phase
    in [0, 2π) for each: ([count, 3] float64, [count] float64)."""
    g = rng(seed, *keys)
    d = g.standard_normal((count, 3))
    d *= radius / np.linalg.norm(d, axis=1, keepdims=True)
    return d, 2.0 * np.pi * g.random(count)


def rhs(points: torch.Tensor, src: np.ndarray, phase: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Right-hand sides [n, count] in ``dtype`` on the points' device: the
    potential 1/(4π‖x − s‖) of each source, times e^{iθ} for a complex
    dtype.  Worked in float64 from the float32 points, then rounded once."""
    x = points.to(torch.float64)
    s = torch.as_tensor(src, dtype=torch.float64, device=points.device)
    r = torch.sqrt(((x[:, None, :] - s[None, :, :]) ** 2).sum(-1))
    b = 1.0 / (4.0 * math.pi * r)
    if dtype.is_complex:
        th = torch.as_tensor(phase, dtype=torch.float64, device=points.device)
        b = b * torch.polar(torch.ones_like(th), th)[None, :]
    return b.to(dtype)
