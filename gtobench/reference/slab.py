"""The goal-set configuration's scene: an axis-aligned table slab, as the
eps-band shaped obstacle cost on the grid's corners.

    cost = -d + eps / 2          d <= 0
           (d - eps)^2 / (2 eps)  0 < d < eps
           0                      d >= eps

with d the exact signed distance to the box (negative inside), computed
in float64 at the grid's float32 corners and stored as float32, the field
type the configuration states.
"""

from __future__ import annotations

import numpy as np

from gtobench.reference.synth7 import Grid


def signed_distance(pts: np.ndarray, slab: dict) -> np.ndarray:
    lo = np.array([slab["x"][0], slab["y"][0], slab["z"][0]])
    hi = np.array([slab["x"][1], slab["y"][1], slab["z"][1]])
    d = np.abs(pts - (lo + hi) / 2) - (hi - lo) / 2
    return np.linalg.norm(np.maximum(d, 0.0), axis=-1) + np.minimum(d.max(axis=-1), 0.0)


def shaped(d: np.ndarray, eps: float) -> np.ndarray:
    return np.where(d <= 0, -d + eps / 2, np.where(d < eps, (d - eps) ** 2 / (2 * eps), 0.0))


def cost_field(slab: dict, grid: Grid) -> np.ndarray:
    """(S,) float32 cost of the slab at the grid's corners."""
    d = signed_distance(grid.corners().astype(np.float64), slab)
    return shaped(d, slab["epsilon"]).astype(np.float32)
