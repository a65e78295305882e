"""Planning utilities (port of grasptrajopt_tpu/planning/utils.py: the
data directory and robot configs, :22-41, and the warm start's
interpolation, :90-95)."""

from __future__ import annotations

import os
from typing import Optional

import torch


def get_data_dir() -> str:
    """Robot asset tree (URDFs, meshes, configs): GTO_DATA_DIR, else
    `data/` at the repository root."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.environ.get("GTO_DATA_DIR", os.path.join(root, "data"))


def load_robot_config(robot_name: str, data_dir: Optional[str] = None) -> dict:
    """The `robot_cfg` block of `<data_dir>/configs/<robot_name>.yaml`."""
    import yaml  # only robot data needs it

    path = os.path.join(data_dir or get_data_dir(), "configs", f"{robot_name}.yaml")
    with open(path) as f:
        return yaml.load(f, Loader=yaml.Loader)["robot_cfg"]


def interpolate_waypoints(qc, qs, n: int):
    """The 2-waypoint clamped cubic (smoothstep) warm start: n samples at
    t = linspace(0, 1, n + 2)[1:-1] from qc (ndof,) to qs (..., ndof)
    -> (..., n, ndof)."""
    t = torch.linspace(0.0, 1.0, n + 2, dtype=torch.float64)[1:-1].to(qc.dtype).to(qc.device)
    s = 3.0 * t**2 - 2.0 * t**3
    return qc + s[:, None] * (qs - qc)[..., None, :]
