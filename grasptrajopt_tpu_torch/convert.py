"""Carry the JAX package's model state and solver parameters across.

There are no learned weights: the "parameters" are the robot model's
arrays, the solver's parameter dict and points mode's scene sets. Every
function takes plain numpy arrays (callers holding JAX objects convert
with `np.asarray`), so this module, like the rest of the port, never
imports JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from grasptrajopt_tpu_torch.fields.voxel_grid import VoxelGrid
from grasptrajopt_tpu_torch.models.kinematics import KinematicModel
from grasptrajopt_tpu_torch.planning.gto_models import GTORobotModel


def robot_from_numpy(state: Mapping, device="cuda", dtype=torch.float32) -> GTORobotModel:
    """Build the port's robot model from a JAX `GTORobotModel`'s state.

    `state` keys:
      name, frame_names, actuated_joint_names, param_joints — names;
      parent, joint_type, joint_index (F,), axis (F, 3), T_fixed (F, 4, 4)
        — the flattened joint tree;
      lower, upper, velocity (ndof,) — actuated-joint limits;
      surface_points, surface_normals — {link: (Pl, 3)} raw mesh-frame
        samples in link order; visual_offsets — {link: (4, 4)};
      grid_origin (3,), grid_shape (3,), grid_resolution — the voxel grid
        (optional).
    """
    kin = KinematicModel(
        state["frame_names"], state["parent"], state["joint_type"],
        state["joint_index"], state["axis"], state["T_fixed"],
        state["actuated_joint_names"], name=state.get("name", "robot"),
    )
    robot = GTORobotModel(
        kin, state["param_joints"], state["lower"], state["upper"], state["velocity"],
        state["surface_points"], state["surface_normals"], state["visual_offsets"],
        grid_resolution=float(state.get("grid_resolution", 0.05)),
        device=device, dtype=dtype,
    )
    if "grid_origin" in state:
        robot.grid = VoxelGrid(
            origin=tuple(float(v) for v in np.asarray(state["grid_origin"])),
            shape=tuple(int(v) for v in np.asarray(state["grid_shape"])),
            resolution=float(state["grid_resolution"]),
        )
    return robot


def scene_sets_from_numpy(obstacle, target, device="cuda", dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Points mode's scene sets as the planner's shared params: `obstacle`
    and `target` are one `ScenePointSet` each (fields.scene_points, or the
    JAX package's, which holds the same arrays) or same-length sequences of
    them, one per object, stacked as (C, K, 3). Also the validity masks
    (C, K) of the fixed-capacity sets (rows past `count` are padding)."""
    out = {}
    for key, sets in (("scene", obstacle), ("target", target)):
        sets = list(sets) if isinstance(sets, (list, tuple)) else [sets]
        K = sets[0].points.shape[0]
        out[f"{key}_points"] = torch.as_tensor(np.stack([s.points for s in sets]), dtype=dtype, device=device)
        out[f"{key}_normals"] = torch.as_tensor(np.stack([s.normals for s in sets]), dtype=dtype, device=device)
        out[f"{key}_mask"] = torch.as_tensor(np.stack([np.arange(K) < s.count for s in sets]), device=device)
    return out


_INDEX_KEYS = ("field_base", "goal_seed")


def params_from_numpy(params: Mapping, device="cuda", dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A JAX solver params dict (tf_goal, q_param, goal_mask,
    base_position, field_base, packed_fields, optional goal_seed) as
    tensors: floats in `dtype`, masks as bool, row offsets and goal
    indices as int64."""
    out = {}
    for k, v in params.items():
        a = np.asarray(v)
        if k in _INDEX_KEYS:
            out[k] = torch.as_tensor(a.astype(np.int64), device=device)
        elif a.dtype == np.bool_:
            out[k] = torch.as_tensor(a, device=device)
        else:
            out[k] = torch.as_tensor(a, dtype=dtype, device=device)
    return out
