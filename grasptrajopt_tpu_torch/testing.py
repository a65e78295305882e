"""Self-contained synthetic robot for tests, smoke runs and dry runs.

Port of grasptrajopt_tpu/testing.py: the 7-DoF synthetic arm `synth7`
built from an embedded URDF with primitive geometry (10 collision links),
its constants, and a reachable synthetic grasp pose. Also the arm's
gripper as a model of its own (`SYNTH_GRIPPER_URDF`: the hand and both
fingers, rooted at the hand, as the pipeline's grasp pre-filter needs it)
and `SYNTH_EVAL_CONFIG`, the robot config the closed-loop harness reads.
"""

from __future__ import annotations

import numpy as np
import torch

from grasptrajopt_tpu_torch.planning.gto_models import GTORobotModel

SYNTH_ARM_URDF = """
<robot name="synth7">
  <link name="base_link">
    <visual><geometry><cylinder radius="0.06" length="0.1"/></geometry></visual>
  </link>
  <link name="l1"><visual><geometry><box size="0.08 0.08 0.2"/></geometry></visual></link>
  <link name="l2"><visual><geometry><box size="0.07 0.07 0.25"/></geometry></visual></link>
  <link name="l3"><visual><geometry><box size="0.06 0.06 0.2"/></geometry></visual></link>
  <link name="l4"><visual><geometry><box size="0.06 0.06 0.2"/></geometry></visual></link>
  <link name="l5"><visual><geometry><box size="0.05 0.05 0.15"/></geometry></visual></link>
  <link name="l6"><visual><geometry><box size="0.05 0.05 0.1"/></geometry></visual></link>
  <link name="hand"><visual><geometry><box size="0.08 0.1 0.05"/></geometry></visual></link>
  <link name="finger_l"><visual><geometry><box size="0.015 0.02 0.06"/></geometry></visual></link>
  <link name="finger_r"><visual><geometry><box size="0.015 0.02 0.06"/></geometry></visual></link>
  <joint name="j1" type="revolute">
    <parent link="base_link"/><child link="l1"/>
    <origin xyz="0 0 0.1" rpy="0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-2.9" upper="2.9" velocity="2.1"/>
  </joint>
  <joint name="j2" type="revolute">
    <parent link="l1"/><child link="l2"/>
    <origin xyz="0 0 0.2" rpy="0 0 0"/><axis xyz="0 1 0"/>
    <limit lower="-1.8" upper="1.8" velocity="2.1"/>
  </joint>
  <joint name="j3" type="revolute">
    <parent link="l2"/><child link="l3"/>
    <origin xyz="0 0 0.25" rpy="0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-2.9" upper="2.9" velocity="2.1"/>
  </joint>
  <joint name="j4" type="revolute">
    <parent link="l3"/><child link="l4"/>
    <origin xyz="0 0 0.2" rpy="0 0 0"/><axis xyz="0 1 0"/>
    <limit lower="-3.0" upper="0.1" velocity="2.1"/>
  </joint>
  <joint name="j5" type="revolute">
    <parent link="l4"/><child link="l5"/>
    <origin xyz="0 0 0.2" rpy="0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-2.9" upper="2.9" velocity="2.6"/>
  </joint>
  <joint name="j6" type="revolute">
    <parent link="l5"/><child link="l6"/>
    <origin xyz="0 0 0.15" rpy="0 0 0"/><axis xyz="0 1 0"/>
    <limit lower="-0.1" upper="3.7" velocity="2.6"/>
  </joint>
  <joint name="j7" type="revolute">
    <parent link="l6"/><child link="hand"/>
    <origin xyz="0 0 0.1" rpy="0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-2.9" upper="2.9" velocity="2.6"/>
  </joint>
  <joint name="finger_joint_l" type="prismatic">
    <parent link="hand"/><child link="finger_l"/>
    <origin xyz="0 0.03 0.05" rpy="0 0 0"/><axis xyz="0 1 0"/>
    <limit lower="0" upper="0.04" velocity="0.2"/>
  </joint>
  <joint name="finger_joint_r" type="prismatic">
    <parent link="hand"/><child link="finger_r"/>
    <origin xyz="0 -0.03 0.05" rpy="0 0 0"/><axis xyz="0 -1 0"/>
    <limit lower="0" upper="0.04" velocity="0.2"/>
  </joint>
</robot>
"""

# the arm's hand, fingers and finger joints, with the hand as the root
SYNTH_GRIPPER_URDF = """
<robot name="synth7_gripper">
  <link name="hand"><visual><geometry><box size="0.08 0.1 0.05"/></geometry></visual></link>
  <link name="finger_l"><visual><geometry><box size="0.015 0.02 0.06"/></geometry></visual></link>
  <link name="finger_r"><visual><geometry><box size="0.015 0.02 0.06"/></geometry></visual></link>
  <joint name="finger_joint_l" type="prismatic">
    <parent link="hand"/><child link="finger_l"/>
    <origin xyz="0 0.03 0.05" rpy="0 0 0"/><axis xyz="0 1 0"/>
    <limit lower="0" upper="0.04" velocity="0.2"/>
  </joint>
  <joint name="finger_joint_r" type="prismatic">
    <parent link="hand"/><child link="finger_r"/>
    <origin xyz="0 -0.03 0.05" rpy="0 0 0"/><axis xyz="0 -1 0"/>
    <limit lower="0" upper="0.04" velocity="0.2"/>
  </joint>
</robot>
"""

SYNTH_COLLISION_LINKS = [
    "base_link", "l1", "l2", "l3", "l4", "l5", "l6", "hand", "finger_l", "finger_r",
]
SYNTH_PARAM_JOINTS = ["finger_joint_l", "finger_joint_r"]
SYNTH_LINK_EE = "hand"
SYNTH_LINK_GRIPPER = "hand"
SYNTH_DEFAULT_POSE = np.array([0.0, 0.6, 0.0, -1.4, 0.0, 1.8, 0.0, 0.04, 0.04])

# the keys the closed-loop harness (synthetic_eval.evaluate_scenes) reads
# from a robot config; robot_name picks the scene layout and grasp
# convention of the synthetic scenes (the panda's, which the e2e slice uses)
SYNTH_EVAL_CONFIG = {
    "robot_name": "panda",
    "link_ee": SYNTH_LINK_EE,
    "link_gripper": SYNTH_LINK_GRIPPER,
    "axis_standoff": "z",
    "gripper_open_offsets": (0.04, 0.04),
    "default_pose": SYNTH_DEFAULT_POSE.tolist(),
    "depth_threshold": 1.5,
}


def make_synthetic_gto_robot(
    device="cuda", dtype=torch.float32, points_per_link: int = 100, grid_resolution: float = 0.05
) -> GTORobotModel:
    robot = GTORobotModel.from_urdf_string(
        SYNTH_ARM_URDF,
        param_joints=SYNTH_PARAM_JOINTS,
        collision_link_names=SYNTH_COLLISION_LINKS,
        points_per_link=points_per_link,
        grid_resolution=grid_resolution,
        device=device,
        dtype=dtype,
    )
    robot.setup_workspace_field(arm_len=1.1, arm_height=0.2)
    return robot


def make_synthetic_gripper(
    device="cuda", dtype=torch.float32, points_per_link: int = 100
) -> GTORobotModel:
    """The arm's gripper alone (both finger joints are its joints). Its
    surface points equal the arm's for the same links: sampling is seeded
    by the link's name."""
    return GTORobotModel.from_urdf_string(
        SYNTH_GRIPPER_URDF, points_per_link=points_per_link, device=device, dtype=dtype
    )


def make_synthetic_goal(seed: int = 0) -> np.ndarray:
    """A reachable grasp pose in front of the synthetic arm."""
    rng = np.random.default_rng(seed)
    RT = np.eye(4)
    # gripper pointing down-ish at a point on a virtual table
    RT[:3, 3] = [0.45 + 0.1 * rng.random(), 0.2 * (rng.random() - 0.5), 0.55]
    c, s = np.cos(np.pi), np.sin(np.pi)
    RT[:3, :3] = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])  # flip z down
    return RT
