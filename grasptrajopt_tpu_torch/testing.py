"""Self-contained synthetic robot for tests, smoke runs and dry runs.

Port of grasptrajopt_tpu/testing.py: the 7-DoF synthetic arm `synth7`
built from an embedded URDF with primitive geometry (10 collision links),
its constants, a reachable synthetic grasp pose and a synthetic tabletop
cost field. Also the grasp trajectory NLP of the JAX package's full-scale
builder test (tests/test_builder_fullscale.py) stated through the builder
DSL (`make_dsl_trajectory_problem`), and the arm's
gripper as a model of its own (`SYNTH_GRIPPER_URDF`: the hand and both
fingers, rooted at the hand, as the pipeline's grasp pre-filter needs it)
and `SYNTH_EVAL_CONFIG`, the robot config the closed-loop harness reads.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from grasptrajopt_tpu_torch.opt.builder import OptimizationBuilder
from grasptrajopt_tpu_torch.opt.taxonomy import Optimization
from grasptrajopt_tpu_torch.planning.gto_models import GTORobotModel
from grasptrajopt_tpu_torch.spatial import invt, transform_points

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

# a double pendulum with inertials, swinging about y: the inverse
# dynamics checks' robot
DOUBLE_PENDULUM_URDF = """
<robot name="double_pendulum">
  <link name="base"/>
  <link name="l1">
    <inertial><origin xyz="0 0 -0.5"/><mass value="1.0"/>
      <inertia ixx="0.02" ixy="0" ixz="0" iyy="0.02" iyz="0" izz="0.001"/></inertial>
  </link>
  <link name="l2">
    <inertial><origin xyz="0 0 -0.4"/><mass value="0.7"/>
      <inertia ixx="0.01" ixy="0" ixz="0" iyy="0.01" iyz="0" izz="0.001"/></inertial>
  </link>
  <joint name="j1" type="revolute">
    <parent link="base"/><child link="l1"/><origin xyz="0 0 2"/>
    <axis xyz="0 1 0"/><limit lower="-3.14" upper="3.14" velocity="10"/>
  </joint>
  <joint name="j2" type="revolute">
    <parent link="l1"/><child link="l2"/><origin xyz="0 0 -1"/>
    <axis xyz="0 1 0"/><limit lower="-3.14" upper="3.14" velocity="10"/>
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
    device="cuda", dtype=torch.float32, points_per_link: int = 100, grid_resolution: float = 0.05,
    time_derivs=(0, 1),
) -> GTORobotModel:
    robot = GTORobotModel.from_urdf_string(
        SYNTH_ARM_URDF,
        time_derivs=time_derivs,
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


def make_synthetic_scene_field(robot: GTORobotModel, seed: int = 0) -> np.ndarray:
    """A synthetic tabletop obstacle cost field on the robot's grid: host
    float32 (size,), the JAX package's values."""
    rng = np.random.default_rng(seed)
    grid = robot.grid
    pts = grid.grid_points()
    # table slab at z in [0.38, 0.42], x in [0.3, 0.9]
    in_table = (
        (pts[:, 2] > 0.38) & (pts[:, 2] < 0.42) & (pts[:, 0] > 0.3) & (pts[:, 0] < 0.9)
    )
    field = np.zeros(grid.size, dtype=np.float32)
    field[in_table] = 0.05 + 0.01 * rng.random(int(in_table.sum()))
    return field


class DSLTrajectoryProblem(NamedTuple):
    """The grasp trajectory NLP through the builder: `opt`, the box (lo,
    hi) over its flat decision vector, the initial seed and the parameters
    as block dicts (numpy), and the time step and standoff step."""

    opt: Optimization
    lo: np.ndarray
    hi: np.ndarray
    seed: Dict[str, np.ndarray]
    params: Dict[str, np.ndarray]
    dt: float
    t_standoff: int


def make_dsl_trajectory_problem(
    robot: GTORobotModel, field, tf_goal, qc, T: int = 50, standoff_offset: int = -10, Tmax: float = 10.0,
) -> DSLTrajectoryProblem:
    """The structured planner's grasp trajectory problem (GTOPlanner with
    one goal, standoff along z) stated through the DSL, as the JAX
    package's full-scale builder test states it: decision blocks q (n, T)
    and dq (n, T - 1) of the robot's optimized joints; costs: the gripper's
    surface points matched at the goal (last step) and at the 0.1 m
    standoff (step T + standoff_offset), 10 x the squared trilinear field
    at every body point, 0.01 |dq|^2; constraints: q and dq start at qc
    and 0, explicit Euler q_{t+1} = q_t + dt dq_t, joint limits on q (as
    inequalities; the box (lo, hi) holds them too). `robot` needs the
    time derivatives (0, 1) and a grid; `field` (size,), `tf_goal` (4, 4)
    and `qc` (ndof,) are host arrays. Everything is float64 on the
    robot's device."""
    name = robot.get_name()
    dev = robot.device
    n_opt = robot.num_opt_joints
    t_standoff = T + standoff_offset
    dt = Tmax / (T - 1)
    qc = np.asarray(qc, np.float64)
    qc_opt = qc[robot.optimized_joint_indexes]
    q_param = qc[robot.parameter_joint_indexes]

    def f64(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=dev)

    builder = OptimizationBuilder(T=T, robots=[robot], device=dev)
    gpts = f64(robot.surface_points[SYNTH_LINK_GRIPPER])
    ee_frame = robot.frame_of(SYNTH_LINK_EE)
    grip_frame = robot.frame_of(SYNTH_LINK_GRIPPER)
    pose_standoff = np.eye(4)
    pose_standoff[2, 3] = -0.1  # the planner's default standoff, along z
    tf_goal = f64(tf_goal)
    tf_standoff = tf_goal @ f64(pose_standoff)
    grid = robot.grid
    field = f64(field)

    def goal_cost(x, p):
        Q = builder.get_robot_states_and_parameters(x, p, name)  # (ndof, T)

        def diffs(q_full, tf):
            frames = robot.fk_all(q_full)
            gripper_tf = invt(frames[ee_frame]) @ frames[grip_frame]
            pts_cur = transform_points(frames[grip_frame], gpts)
            return pts_cur - transform_points(tf @ gripper_tf, gpts)

        d_final = diffs(Q[:, T - 1], tf_goal)
        d_stand = diffs(Q[:, t_standoff], tf_standoff)
        return torch.sum(d_final**2) + torch.sum(d_stand**2)

    def obstacle_cost(x, p):
        Q = builder.get_robot_states_and_parameters(x, p, name)
        pts = robot.fk_surface_points(Q.T)  # (T, P, 3)
        return 10.0 * torch.sum(grid.lookup(field, pts, "trilinear") ** 2)

    def velocity_cost(x, p):
        dq = x[robot.state_optimized_name(1)]
        return 0.01 * torch.sum(dq * dq)

    builder.add_cost_term("goal", goal_cost)
    builder.add_cost_term("obstacle", obstacle_cost)
    builder.add_cost_term("velocity", velocity_cost)
    builder.initial_configuration(name, qc_opt)
    builder.initial_configuration(name, np.zeros(n_opt), time_deriv=1)
    builder.integrate_model_states(name, 1, dt)
    builder.enforce_model_limits(name, 0)
    opt = builder.build()

    free = np.full(n_opt * (T - 1), np.inf)
    lo = np.concatenate([np.tile(robot.lower_optimized_joint_limits, T), -free])
    hi = np.concatenate([np.tile(robot.upper_optimized_joint_limits, T), free])
    seed = {
        robot.state_optimized_name(0): np.tile(qc_opt[:, None], (1, T)),
        robot.state_optimized_name(1): np.zeros((n_opt, T - 1)),
    }
    params = {
        robot.state_parameter_name(0): np.tile(q_param[:, None], (1, T)),
        robot.state_parameter_name(1): np.zeros((robot.num_param_joints, T - 1)),
    }
    return DSLTrajectoryProblem(opt, lo, hi, seed, params, dt, t_standoff)
