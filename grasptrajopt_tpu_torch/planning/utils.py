"""Planning utilities (port of grasptrajopt_tpu/planning/utils.py:90-95)."""

from __future__ import annotations

import torch


def interpolate_waypoints(qc, qs, n: int):
    """The 2-waypoint clamped cubic (smoothstep) warm start: n samples at
    t = linspace(0, 1, n + 2)[1:-1] from qc (ndof,) to qs (..., ndof)
    -> (..., n, ndof)."""
    t = torch.linspace(0.0, 1.0, n + 2, dtype=torch.float64)[1:-1].to(qc.dtype).to(qc.device)
    s = 3.0 * t**2 - 2.0 * t**3
    return qc + s[:, None] * (qs - qc)[..., None, :]
