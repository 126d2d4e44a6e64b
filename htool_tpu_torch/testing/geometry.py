"""Deterministic test geometries.

Copy of ``htool_tpu/testing/geometry.py``: the same NumPy seeding gives
bit-identical points in both packages, so a parity test can feed one point
cloud to each.
"""

from __future__ import annotations

import numpy as np

__all__ = ["create_sphere", "create_disk", "create_rotated_ellipse", "create_random_points"]


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


def create_disk(n: int, radius: float = 1.0, center=(0.0, 0.0), z: float = 0.0, seed: int = 0) -> np.ndarray:
    """Uniform points in a planar disk embedded in 3D. Returns [n, 3]."""
    rng = np.random.RandomState(seed)
    r = radius * np.sqrt(rng.uniform(0.0, 1.0, n))
    theta = 2.0 * np.pi * rng.uniform(0.0, 1.0, n)
    pts = np.stack(
        [
            center[0] + r * np.cos(theta),
            center[1] + r * np.sin(theta),
            np.full(n, z),
        ],
        axis=1,
    )
    return pts


def create_rotated_ellipse(
    n: int, a: float = 1.0, b: float = 0.5, angle: float = 0.0, center=(0.0, 0.0), z: float = 0.0, seed: int = 0
) -> np.ndarray:
    """Points on a rotated ellipse boundary embedded in 3D. Returns [n, 3]."""
    rng = np.random.RandomState(seed)
    t = 2.0 * np.pi * rng.uniform(0.0, 1.0, n)
    x = a * np.cos(t)
    y = b * np.sin(t)
    c, s = np.cos(angle), np.sin(angle)
    pts = np.stack(
        [center[0] + c * x - s * y, center[1] + s * x + c * y, np.full(n, z)],
        axis=1,
    )
    return pts


def create_random_points(n: int, dim: int = 3, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return rng.uniform(-1.0, 1.0, (n, dim))
