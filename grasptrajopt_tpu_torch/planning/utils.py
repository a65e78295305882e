"""Planning utilities (port of grasptrajopt_tpu/planning/utils.py: the
data directory and robot configs, :22-41, `rotZ` and `default_pose`,
:44-61, as host numpy, and the warm start's interpolation, :90-95)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from grasptrajopt_tpu_torch.ops.constants import device_vector


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


def rotZ(theta: float) -> np.ndarray:
    """Homogeneous (4, 4) float64 rotation by theta about z."""
    c, s = np.cos(theta), np.sin(theta)
    return np.array(
        [[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float64
    )


def default_pose(robot_model) -> np.ndarray:
    """Canonical start configuration (ndof,) float32 of fetch or panda;
    zeros for any other robot (synth7 included), as in the JAX package."""
    q = np.zeros(robot_model.ndof, dtype=np.float32)
    if robot_model.name == "fetch":
        q[2] = 0.4
        q[3] = 0.009195
        q[4] = 0.908270
        q[[5, 6, 7, 8, 9, 10, 11]] = [1.32, 0.7, 0.0, -2.0, 0.0, -0.57, 0.0]
    elif robot_model.name == "panda":
        q = np.array([0.0, -1.285, 0, -2.356, 0.0, 1.571, 0.785, 0.0, 0.0], dtype=np.float32)
    return q


def interpolate_waypoints(qc, qs, n: int):
    """The 2-waypoint clamped cubic (smoothstep) warm start: n samples at
    t = linspace(0, 1, n + 2)[1:-1] from qc (ndof,) to qs (..., ndof)
    -> (..., n, ndof)."""
    # the samples computed on the host as before, placed by fills: a copy
    # from host memory would synchronize the stream
    t = device_vector(torch.linspace(0.0, 1.0, n + 2, dtype=torch.float64)[1:-1].to(qc.dtype).tolist(),
                      qc.dtype, qc.device)
    s = 3.0 * t**2 - 2.0 * t**3
    return qc + s[:, None] * (qs - qc)[..., None, :]
