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
from grasptrajopt_tpu_torch.testing import SYNTH_GRIPPER_URDF

# The parity tests run many small float64 ops on the CPU in each of the
# test workers at once: one intra-op thread a worker keeps torch from
# oversubscribing the cores (each worker otherwise starts one thread a core).
torch.set_num_threads(1)


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


def make_jax_synth_gripper(points_per_link: int = 10):
    """The JAX package's model of the synthetic arm's gripper, float64,
    from the port's URDF string (the hand and both fingers)."""
    return GTORobotModel(
        model_dir="", urdf_string=SYNTH_GRIPPER_URDF, points_per_link=points_per_link, dtype=jnp.float64
    )


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


def jax_ik_restarts(jr, B: int, num_seeds: int, seed: int = 0) -> np.ndarray:
    """(B, num_seeds - 1, n_opt): the restarts the JAX IKSolver's batched
    multistart draws (one key per goal from jax.random.split)."""
    import jax

    lo = jnp.asarray(jr.lower_optimized_joint_limits, jnp.float64)
    hi = jnp.asarray(jr.upper_optimized_joint_limits, jnp.float64)
    lo_s, hi_s = jnp.clip(lo, -3.2, 3.2), jnp.clip(hi, -3.2, 3.2)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return np.stack([
        np.asarray(lo_s + jax.random.uniform(k, (num_seeds - 1, lo.shape[0]), dtype=jnp.float64) * (hi_s - lo_s))
        for k in keys
    ])


def use_jax_restarts(ik_solver, jr):
    """Make the port's IK solver draw its multistart restarts as the JAX
    package does (the port's own are a torch.Generator's)."""
    solve = ik_solver.solve_ik_batch

    def solve_with_jax_restarts(q_0, RTs, sdf_cost_obstacle=None, base_position=(0.0, 0.0, 0.0),
                                multistart=False, seed=0, restarts=None):
        if multistart and restarts is None:
            restarts = torch.as_tensor(jax_ik_restarts(jr, RTs.shape[0], ik_solver.num_seeds, seed))
        return solve(q_0, RTs, sdf_cost_obstacle, base_position, multistart, seed, restarts)

    ik_solver.solve_ik_batch = solve_with_jax_restarts


def observation(scene_type: str = "tabletop", size: int = 64, views: int = 1, scene_id: int = 10, index: int = 0):
    """One rendered observation of a synthetic scene's `index`-th object
    (nearest first on the tabletop, the random order on the shelf): a dict
    of depth, target mask and camera pose (lists when views > 1), K, the
    object's world grasps and the robot base position."""
    from grasptrajopt_tpu_torch.envs.synthetic import SyntheticSceneEnv

    env = SyntheticSceneEnv(robot_name="panda", scene_type=scene_type, n_objects=5, width=size, height=size)
    meta = env.setup_scene(scene_id)
    env.reset_scene()
    name = meta["nearest_first" if scene_type == "tabletop" else "random"].split(",")[index]
    uid = env._placed(name).uid
    depths, masks, poses = [], [], []
    for cp in env.camera_poses(views):
        d, ids, _, K = env.get_observation(cp)
        depths.append(d)
        masks.append(ids == uid)
        poses.append(cp)
    one = (lambda a: a) if views > 1 else (lambda a: a[0])
    return {
        "depth": one(depths), "target_mask": one(masks), "cam_pose": one(poses), "K": K,
        "grasps_world": env.grasps_world(name), "base_position": np.asarray(env.base_position),
        "name": name,
    }


def mobile_tabletop_cloud(size: int = 48) -> np.ndarray:
    """The synthetic tabletop (scene 10) at size x size seen as the mobile
    harness sees it to place the base: from its parked base (-0.8, 0.3,
    yaw -0.3) on synth7's mount (the env's base height, 0.7 m); every
    valid point in that base frame, float64 (N, 3)."""
    from grasptrajopt_tpu_torch import synthetic_eval_mobile as mobile
    from grasptrajopt_tpu_torch.envs.synthetic import SyntheticSceneEnv
    from grasptrajopt_tpu_torch.fields.depth_point_cloud import DepthPointCloud

    env = SyntheticSceneEnv(robot_name="panda", scene_type="tabletop", n_objects=5, width=size, height=size)
    env.setup_scene(10)
    env.reset_scene()
    RT_base = mobile.base_pose_matrix(-0.8, 0.3, -0.3)
    RT_base[2, 3] = env.base_position[2]
    target = env.TABLE_POS + [0.0, 0.0, env.TABLE_HEIGHT]
    depth, _, cam_w, K = env.get_observation(mobile.head_camera_pose(RT_base, target))
    cloud = DepthPointCloud(depth, K, np.linalg.inv(RT_base) @ cam_w, threshold=np.inf, device="cpu")
    return cloud.points.astype(np.float64)


def run_escalation_tier(tier: str, monkeypatch, T: int = 12, size: int = 48, n_goals: int = 3):
    """One escalation tier of GraspPipeline (`exact`: points mode; `deep`:
    the deeper field re-solve) in both packages, with the arguments
    plan_object gives it, on a two-view shelf observation (scene 10, the
    random order's first object, 10 cm workspace grid): the synthetic arm
    and its gripper at 10 points per link in float64, the shelf's knobs
    (standoff -0.2 m, planning fields from the first view over a 1 cm
    dedup), the bench's planner flavour at horizon T. Each package builds
    its own fields, obstacle clouds and tier planner (its module's
    GTOPlanner is patched to horizon T); both get the same IK solutions
    (the port's screen). Returns a dict per package ("port", "jax") of
    plans (n, ndof, T), costs (n,) and the replay scorer's verdicts on the
    plans against that package's fused obstacle cloud."""
    import functools

    import grasptrajopt_tpu.planning.pipeline as jax_pipeline
    import grasptrajopt_tpu_torch.planning.pipeline as port_pipeline
    from grasptrajopt_tpu.planning import evaluate as jax_evaluate
    from grasptrajopt_tpu.testing import SYNTH_DEFAULT_POSE
    from grasptrajopt_tpu_torch.planning import evaluate as port_evaluate
    from grasptrajopt_tpu_torch.testing import SYNTH_EVAL_CONFIG, make_synthetic_gripper

    for module in (jax_pipeline, port_pipeline):
        monkeypatch.setattr(module, "GTOPlanner", functools.partial(module.GTOPlanner, T=T))
    qc = SYNTH_DEFAULT_POSE.astype(np.float64)
    knobs = dict(
        axis_standoff="z", gripper_open_offsets=SYNTH_EVAL_CONFIG["gripper_open_offsets"],
        standoff_distance=-0.2, standoff_offset=-4, goal_capacity=4, ik_capacity=4, ik_iterations=20,
        planner_iterations=3, planner_single_pass=True, planner_coarse_iterations=2, planner_final_trust=True,
        field_downsample=0.01, plan_views=1,
    )
    jr = make_jax_synth_robot(points_per_link=10, grid_resolution=0.1)
    pr = port_robot(jr)
    pipelines = {
        "jax": jax_pipeline.GraspPipeline(jr, make_jax_synth_gripper(10), "hand", "hand", grid=jr.grid, **knobs),
        "port": port_pipeline.GraspPipeline(
            pr, make_synthetic_gripper(device="cpu", dtype=torch.float64, points_per_link=10), "hand", "hand",
            grid=pr.grid, **knobs,
        ),
    }
    obs = observation("shelf", size=size, views=2)
    view_args = (obs["depth"], obs["K"], obs["cam_pose"], obs["target_mask"])
    RT_base = obs["grasps_world"][:n_goals].copy()
    RT_base[:, :3, 3] -= obs["base_position"]
    q, found = pipelines["port"].screen_ik(qc, RT_base)
    assert found.any()
    RT_base, q_solutions = RT_base[found], q[found].T
    out = {}
    for name, p in pipelines.items():
        _, cloud, sdf_all, sdf_obs = p.build_fields(*view_args)
        sdf_all, sdf_obs = np_(sdf_all), np_(sdf_obs)
        if tier == "exact":
            Q, cost = p._plan_pergoal_exact(qc, RT_base, obs["base_position"], q_solutions, 4, *view_args)
        else:
            Q, cost = p._plan_pergoal_deep(qc, RT_base, sdf_all, sdf_obs, obs["base_position"], q_solutions, 4)
        Q, cost = np.asarray(Q), np.asarray(cost)
        scorer = port_evaluate if name == "port" else jax_evaluate
        scores = scorer.score_plans_pergoal(
            p.robot, "hand", Q, RT_base, cloud, obs["base_position"],
            pos_tol=p.rescue_pos_tol, rot_tol_deg=p.rescue_rot_tol_deg,
        )
        out[name] = {"plans": Q, "costs": cost, "scores": scores}
    return out


# the goal-set batch problems' planner flavour: T = 12, single pass, 3 iterations
GOALSET_KW = dict(T=12, iterations=3, single_pass=True, standoff_distance=-0.1)


def goalset_problem(jr):
    """plan_goalset_batch's arguments (host numpy) on the JAX robot's grid:
    B = 2 problems of G = 3 goals (one slot masked), their own scene
    fields, base offsets and noisy warm starts."""
    from grasptrajopt_tpu.testing import SYNTH_DEFAULT_POSE, make_synthetic_goal, make_synthetic_scene_field

    T = GOALSET_KW["T"]
    rng = np.random.default_rng(9)
    B, G = 2, 3
    qc = np.tile(SYNTH_DEFAULT_POSE, (B, 1))
    tf_goal = np.stack([np.stack([make_synthetic_goal(seed=3 * b + g) for g in range(G)]) for b in range(B)])
    goal_mask = np.array([[True, False, True], [True, True, True]])
    f_all = np.stack([make_synthetic_scene_field(jr, seed=b) for b in range(B)]).astype(np.float64)
    f_obs = 0.5 * f_all
    base = np.array([[0.0, 0.0, 0.0], [0.02, -0.01, 0.0]])
    Q0 = np.tile(SYNTH_DEFAULT_POSE, (B, T, 1))
    Q0[..., :7] += rng.normal(scale=0.05, size=(B, T, 7))
    return qc, tf_goal, goal_mask, f_all, f_obs, base, Q0
