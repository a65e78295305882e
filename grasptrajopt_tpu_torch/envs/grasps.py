"""Grasp-set loading for the SceneReplica benchmark.

Parity: examples/pybullet_scenereplica.py:15-38 (load_grasps) and
examples/utils.py:119-132 (parse_grasps). Fetch grasps are JSON files of
ROS-order (xyzw) pose quaternions; Panda grasps are .npy pickles from the
simulated grasp dataset, post-multiplied by rotZ(pi/2) to flip x/y.
"""

from __future__ import annotations

import json
import os

import numpy as np

from grasptrajopt_tpu_torch.envs.camera import pose_from_position_quaternion, rotZ


def parse_grasps(filename: str) -> np.ndarray:
    """JSON grasp file -> (N, 4, 4) poses (Fetch format)."""
    with open(filename, "r") as f:
        data = json.load(f)
    grasps = data["grasps"]
    out = np.zeros((len(grasps), 4, 4), dtype=np.float32)
    for i, g in enumerate(grasps):
        pose = g["pose"]  # [x y z qx qy qz qw] (ROS order)
        trans, rot = pose[:3], pose[3:]
        quat_wxyz = [rot[3], rot[0], rot[1], rot[2]]
        out[i] = pose_from_position_quaternion(trans, quat_wxyz)
    return out


def load_grasps(data_dir: str, robot_name: str, model: str) -> np.ndarray:
    """Per-object grasp set for a robot (N, 4, 4)."""
    if "fetch" in robot_name:
        grasp_file = os.path.join(
            data_dir, "grasp_data", "refined_grasps", f"fetch_gripper-{model}.json"
        )
        return parse_grasps(grasp_file)
    if robot_name == "panda":
        grasp_file = os.path.join(data_dir, "grasp_data", "panda_simulated", f"{model}.npy")
        try:
            raw = np.load(grasp_file, allow_pickle=True)
            RT_grasps = raw.item()["transforms"]
        except (KeyError, UnicodeError):
            raw = np.load(grasp_file, allow_pickle=True, fix_imports=True, encoding="bytes")
            RT_grasps = raw.item()[b"transforms"]
        offset = rotZ(np.pi / 2)
        return np.matmul(RT_grasps, offset)
    raise ValueError(f"robot '{robot_name}' not supported")
