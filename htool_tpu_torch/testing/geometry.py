"""Deterministic test geometries.

Copy of ``htool_tpu/testing/geometry.py::create_sphere``: the same NumPy
seeding gives bit-identical points in both packages, so a parity test can
feed one point cloud to each.
"""

from __future__ import annotations

import numpy as np

__all__ = ["create_sphere"]


def create_sphere(n: int, radius: float = 1.0, center=(0.0, 0.0, 0.0), seed: int = 0) -> np.ndarray:
    """Uniform points on a sphere surface. Returns [n, 3] float64 (NumPy)."""
    rng = np.random.RandomState(seed)
    u = rng.uniform(0.0, 1.0, n)
    v = rng.uniform(0.0, 1.0, n)
    theta = 2.0 * np.pi * u
    phi = np.arccos(np.clip(2.0 * v - 1.0, -1.0, 1.0))
    pts = np.stack(
        [
            radius * np.cos(theta) * np.sin(phi),
            radius * np.sin(theta) * np.sin(phi),
            radius * np.cos(phi),
        ],
        axis=1,
    )
    return pts + np.asarray(center)[None, :]
