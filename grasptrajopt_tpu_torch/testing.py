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

`make_scenereplica_tree` writes a SceneReplica-shaped data tree that the
SceneReplica drivers (`gto_planning`, `evaluate_plans`, `ik_checking`,
`save_videos`, the viewers) run over with `-r synth7`: box "YCB"
objects, analytic grasps, a tabletop and a shelf scene's metadata, the
furniture `SceneReplicaEnv` loads, and synth7's URDFs for the simulator
(`SYNTH_SIM_URDF`) and its gripper.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, NamedTuple

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


# synth7 for the simulator: the arm's chain and links unchanged, plus two
# fixed links without geometry, so that the Panda wrapper's indices
# (envs/pybullet_api.py: ee_index 7, camera_link_index 10, finger_index
# [7, 8]) fit in pybullet's depth-first joint order: `ee_link` on the hand
# before the fingers (joint 7), `camera_link` on the base after the arm's
# subtree (joint 10). The camera sits 1 m above the base and 0.2 m in front
# of it, turned to look along +x and 1 rad down (the Panda wrapper views
# along the link's -y with its +z up): it sees the table and the shelf's
# lowest board, and not the arm at its retract pose, behind the base.
SYNTH_SIM_URDF = SYNTH_ARM_URDF.replace(
    '  <joint name="finger_joint_l" type="prismatic">',
    """  <link name="ee_link"/>
  <joint name="ee_joint" type="fixed">
    <parent link="hand"/><child link="ee_link"/><origin xyz="0 0 0" rpy="0 0 0"/>
  </joint>
  <joint name="finger_joint_l" type="prismatic">""",
    1,
).replace(
    "</robot>",
    """  <link name="camera_link"/>
  <joint name="camera_joint" type="fixed">
    <parent link="base_link"/><child link="camera_link"/>
    <origin xyz="0.2 0 1.0" rpy="1.0 0 1.5707963267948966"/>
  </joint>
</robot>""",
)

# the rest of the robot config the SceneReplica drivers read (the keys of
# a data tree's configs/<robot>.yaml), for synth7 in a tree written by
# make_scenereplica_tree; the Panda conventions (robot_name "panda": its
# wrapper, base position and grasp files)
SYNTH_SCENEREPLICA_CONFIG = {
    **SYNTH_EVAL_CONFIG,
    "urdf_robot_path": "data/robots/synth7/synth7.urdf",
    "urdf_gripper_path": "data/robots/synth7/synth7_gripper.urdf",
    "param_joints": list(SYNTH_PARAM_JOINTS),
    "collision_link_names": list(SYNTH_COLLISION_LINKS),
    "retract_distance": 0.3,
    "finger_index": [7, 8],
    "arm_len": 1.1,
    "arm_height": 0.2,
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


# -- a SceneReplica-shaped data tree ------------------------------------------

# the tabletop scene's two objects (meta-<scene>.mat), as the JAX package's
# driver tests place them; the shelf scene's two lie on 6 cm risers on the
# shelf's lowest board with their box z axis toward the robot (rotated -90
# degrees about y), so that the top-down grasps approach horizontally and
# the hand clears the board
TABLETOP_OBJECTS = ("009_gelatin_box", "010_potted_meat_can")
SHELF_OBJECTS = ("004_sugar_box", "005_tomato_soup_can")
GRASP_TURNS = 8  # turns about the approach axis in a grasp set of more than 2
GRASP_HEIGHTS = (0.10, 0.08, 0.12, 0.14)  # panda-convention hand heights above the object's center
FETCH_GRASP_HEIGHTS = (0.30, 0.28, 0.32, 0.34)


def write_box_urdf(path, sx, sy, sz, mass=0.05):
    """A one-link box body (tests/fake_dataset.py's file, byte for byte)."""
    with open(path, "w") as f:
        f.write(
            f"""<robot name="box">
  <link name="base">
    <visual><geometry><box size="{sx} {sy} {sz}"/></geometry></visual>
    <collision><geometry><box size="{sx} {sy} {sz}"/></geometry></collision>
    <inertial><mass value="{mass}"/><inertia ixx="1e-4" ixy="0" ixz="0" iyy="1e-4" iyz="0" izz="1e-4"/></inertial>
  </link>
</robot>
"""
        )


def write_boxes_urdf(path, name: str, boxes) -> None:
    """A static one-link body of several boxes: `boxes` is [((sx, sy, sz),
    (x, y, z))], each box's size and its center in the body frame."""
    parts = "".join(
        f'    <visual><origin xyz="{x} {y} {z}" rpy="0 0 0"/><geometry><box size="{a} {b} {c}"/></geometry></visual>\n'
        f'    <collision><origin xyz="{x} {y} {z}" rpy="0 0 0"/><geometry><box size="{a} {b} {c}"/></geometry></collision>\n'
        for (a, b, c), (x, y, z) in boxes
    )
    with open(path, "w") as f:
        f.write(f'<robot name="{name}">\n  <link name="base">\n{parts}  </link>\n</robot>\n')


def top_down_grasp(height: float = 0.10) -> np.ndarray:
    """Object-frame grasp pose: gripper approach (+z of the hand frame)
    pointing straight down, hand origin `height` above the object center."""
    g = np.eye(4)
    g[:3, :3] = np.diag([1.0, -1.0, -1.0])  # rotX(pi): z down
    g[2, 3] = height
    return g


def top_down_grasp_fetch(height: float = 0.30) -> np.ndarray:
    """Fetch wrist_roll-frame grasp: approach axis +x, pointed straight
    down, wrist `height` above the object center."""
    g = np.eye(4)
    g[:3, :3] = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]])
    g[2, 3] = height
    return g


def scenereplica_grasps(n: int, fetch: bool = False) -> np.ndarray:
    """(n, 4, 4) object-frame grasps: for n <= 2 the JAX package's mini
    dataset's (copies of the one top-down grasp); above, the top-down
    grasp turned about its approach axis (hand z, fetch's x) in
    GRASP_TURNS steps, each turn at the next of the heights."""
    from grasptrajopt_tpu_torch.envs.camera import rotX, rotZ

    make, heights, turn = (top_down_grasp_fetch, FETCH_GRASP_HEIGHTS, rotX) if fetch else (
        top_down_grasp, GRASP_HEIGHTS, rotZ)
    if n <= 2:
        return np.stack([make()] * n)
    out = []
    for i in range(n):
        g = make(heights[(i // GRASP_TURNS) % len(heights)])
        g[:3, :3] = g[:3, :3] @ turn(2.0 * np.pi * (i % GRASP_TURNS) / GRASP_TURNS)[:3, :3]
        out.append(g)
    return np.stack(out)


def make_scenereplica_tree(root: str, scene_id: int = 10, grasps_per_object: int = 2) -> List[str]:
    """Populate `root` with a SceneReplica-shaped tree: 16 box YCB objects,
    panda and fetch grasp files (`scenereplica_grasps`), a tabletop
    scene's metadata (final_scenes) and a shelf scene's (shelf_scenes, so
    that SceneReplicaEnv reads it and does not generate one), the floor,
    cafe_table and shelf URDFs, and synth7's simulator and gripper URDFs
    under robots/synth7. With grasps_per_object=2 the files that the JAX
    package's tests/fake_dataset.make_mini_dataset writes are identical.
    Returns the tabletop scene's object names. Needs a `pybullet` module
    (the real engine or envs.fake_pybullet installed), as the env's
    object list comes with it."""
    import scipy.io

    from grasptrajopt_tpu_torch.envs.fake_pybullet import _mat_to_quat_xyzw
    from grasptrajopt_tpu_torch.envs.scene_replica import YCB_OBJECT_NAMES

    panda = scenereplica_grasps(grasps_per_object)
    fetch = [
        list(g[:3, 3]) + list(_mat_to_quat_xyzw(g[:3, :3]))  # [x y z qx qy qz qw]
        for g in scenereplica_grasps(grasps_per_object, fetch=True)
    ]
    for sub in ("grasp_data/panda_simulated", "grasp_data/refined_grasps", "final_scenes/metadata",
                "shelf_scenes/metadata", "robots/synth7"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for name in YCB_OBJECT_NAMES:
        obj_dir = os.path.join(root, "objects", name)
        os.makedirs(obj_dir, exist_ok=True)
        write_box_urdf(os.path.join(obj_dir, "model_normalized.urdf"), 0.06, 0.06, 0.12)
        np.save(os.path.join(root, "grasp_data", "panda_simulated", f"{name}.npy"),
                np.array({"transforms": panda}, dtype=object))
        with open(os.path.join(root, "grasp_data", "refined_grasps", f"fetch_gripper-{name}.json"), "w") as f:
            json.dump({"grasps": [{"pose": pose} for pose in fetch]}, f)

    names = list(TABLETOP_OBJECTS)
    poses = np.zeros((2, 7))
    poses[0] = [0.7, -0.15, 0.82, 1, 0, 0, 0]  # wxyz identity
    poses[1] = [0.7, 0.15, 0.82, 1, 0, 0, 0]
    meta = {"object_names": names, "nearest_first": [",".join(names)], "random": [",".join(reversed(names))],
            "poses": poses}
    scipy.io.savemat(os.path.join(root, "final_scenes", "metadata", "meta-%06d.mat" % scene_id), meta)

    shelf = list(SHELF_OBJECTS)
    lying = [0.7071067811865476, 0.0, -0.7071067811865476, 0.0]  # wxyz, -90 degrees about y
    shelf_poses = np.array([[0.8, -0.15, 1.03] + lying, [0.8, 0.15, 1.03] + lying])
    scipy.io.savemat(os.path.join(root, "shelf_scenes", "metadata", "meta-%06d.mat" % scene_id), {
        "object_names": shelf, "nearest_first": [",".join(shelf)], "random": [",".join(reversed(shelf))],
        "poses": shelf_poses,
    })

    # furniture where SceneReplicaEnv.reset loads it: the floor at the
    # origin; the cafe table at (0.8, 0, 0), its top at z = 0.78 (where the
    # tabletop objects stand); the shelf at (0.9, 0, 0.95) turned 180
    # degrees about z (its open side, local +x, toward the robot), boards
    # at local z = 0, 0.4 and 0.8 (the lowest one's top at 0.96) and a riser
    # under each shelf object (tops at 1.02)
    for sub in ("floor", "cafe_table", "shelf"):
        os.makedirs(os.path.join(root, "objects", sub), exist_ok=True)
    write_boxes_urdf(os.path.join(root, "objects", "floor", "model_normalized.urdf"), "floor",
                     [((4.0, 4.0, 0.02), (0.0, 0.0, -0.01))])
    write_boxes_urdf(os.path.join(root, "objects", "cafe_table", "cafe_table.urdf"), "cafe_table",
                     [((0.8, 1.2, 0.04), (0.0, 0.0, 0.76)), ((0.1, 0.1, 0.74), (0.0, 0.0, 0.37))])
    boards = [((0.5, 0.84, 0.02), (0.0, 0.0, z)) for z in (0.0, 0.4, 0.8)]
    walls = [((0.5, 0.02, 1.8), (0.0, y, -0.05)) for y in (-0.43, 0.43)] + [((0.02, 0.88, 1.8), (-0.26, 0.0, -0.05))]
    risers = [((0.1, 0.1, 0.06), (0.1, y, 0.04)) for y in (-0.15, 0.15)]
    write_boxes_urdf(os.path.join(root, "objects", "shelf", "shelf.urdf"), "shelf", boards + walls + risers)
    with open(os.path.join(root, "robots", "synth7", "synth7.urdf"), "w") as f:
        f.write(SYNTH_SIM_URDF)
    with open(os.path.join(root, "robots", "synth7", "synth7_gripper.urdf"), "w") as f:
        f.write(SYNTH_GRIPPER_URDF)
    return names
