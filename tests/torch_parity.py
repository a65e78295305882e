"""Shared helpers of the parity tests between grasptrajopt_tpu (JAX, the
reference) and grasptrajopt_tpu_torch (the port): build the synthetic arm
in both packages on identical arrays, passed across as numpy."""

from __future__ import annotations

import numpy as np
import torch

import jax.numpy as jnp

from grasptrajopt_tpu.planning.gto_models import GTORobotModel
from grasptrajopt_tpu.testing import (
    SYNTH_ARM_URDF,
    SYNTH_COLLISION_LINKS,
    SYNTH_PARAM_JOINTS,
)
from grasptrajopt_tpu_torch.convert import robot_from_numpy


def make_jax_synth_robot(points_per_link: int = 10, grid_resolution: float = 0.05):
    """The JAX package's synthetic arm in float64 (optionally on a coarser
    workspace grid to keep CPU field builds small)."""
    robot = GTORobotModel(
        model_dir="",
        urdf_string=SYNTH_ARM_URDF,
        time_derivs=[0, 1],
        param_joints=SYNTH_PARAM_JOINTS,
        collision_link_names=SYNTH_COLLISION_LINKS,
        points_per_link=points_per_link,
        grid_resolution=grid_resolution,
        dtype=jnp.float64,
    )
    robot.setup_workspace_field(arm_len=1.1, arm_height=0.2)
    return robot


def jax_robot_state(jr) -> dict:
    """A JAX GTORobotModel's state as numpy arrays, for robot_from_numpy."""
    kin = jr.kinematics
    links = list(jr._surface_links)
    return {
        "name": jr.urdf.name,
        "frame_names": kin.frame_names,
        "parent": np.asarray(kin.parent),
        "joint_type": np.asarray(kin.joint_type),
        "joint_index": np.asarray(kin.joint_index),
        "axis": np.asarray(kin.axis),
        "T_fixed": np.asarray(kin.T_fixed),
        "actuated_joint_names": kin.actuated_joint_names,
        "param_joints": jr.param_joints,
        "lower": np.asarray(jr.lower_actuated_joint_limits),
        "upper": np.asarray(jr.upper_actuated_joint_limits),
        "velocity": np.asarray(jr.velocity_actuated_joint_limits),
        "surface_points": {n: np.asarray(jr.surface_pc_map[n].points) for n in links},
        "surface_normals": {n: np.asarray(jr.surface_pc_map[n].normals) for n in links},
        "visual_offsets": {n: np.asarray(jr._visual_offsets[n]) for n in links},
        "grid_origin": np.asarray(jr.grid.origin),
        "grid_shape": np.asarray(jr.grid.shape),
        "grid_resolution": jr.grid.resolution,
    }


def port_robot(jr, dtype=torch.float64):
    """The port's model of the same robot, built from the JAX state."""
    return robot_from_numpy(jax_robot_state(jr), device="cpu", dtype=dtype)


def t64(a):
    return torch.tensor(np.array(a, dtype=np.float64))


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
