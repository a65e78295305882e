"""The perception-to-plan path, batch-first: depth images in, plans out.

Mirrors the JAX package's end-to-end benchmark (bench_e2e.py) on the
port, phase by phase:

  1. fields: per observation, the voxel-deduplicated obstacle cloud and
     the target pixels -> the scene and target-free obstacle cost fields
     on the workspace grid (two K1 launches for the whole batch), packed
     into one stacked corner table; then the grasp pre-filter: the
     gripper model's surface points (hand and both fingers) at the open
     finger offsets, placed at every grasp's standoff pose, against the
     obstacle cloud (one more K1 launch);
  2. IK screen: every grasp of every object, each from the start pose and
     ik_seeds - 1 random restarts, as one multistart projected-LM batch
     (no collision term, as bench_e2e.py runs it), gated at 1 cm / 5
     degrees;
  3. ranking: every IK solution interpolated into a seed trajectory and
     scored by the planner's own `rank_seed_scores` (the floor-indexed
     target-free field summed over every rank_t-th step and rank_p-th body
     point, travel as the tie break; goals the screen missed rank inf)
     and `rank_pick`; the winner is the warm start, its goal the optional
     coherence seed;
  4. plan: the goal-set trajectory solve over per-problem stacked fields,
     goal slots = pre-filter keep & IK found (all slots where none
     survives);
  5. rescue: the rescue_k objects whose plans reach their goals worst
     (position error + 2e-3 x rotation error in degrees) have every goal
     slot re-solved as a single-goal problem from its own IK solution, in
     one batch on the same stacked table; an object's best per-goal plan
     replaces its goal-set plan where it reaches better.

`gates` then scores the plans (untimed, as bench_e2e.py): reach under the
IK gates and the plan gates, and the replay collision against each
object's exact obstacle cloud (planning/evaluate.py, one K1 launch an
object).

After the IK screen, `PerceptionToPlan.pergoal` runs the JAX pipeline's
per-goal tiers (planning/pipeline.py `_plan_pergoal_exact` and the
rescue's `plan_pergoal_batch`) for every object of the batch, each goal
slot its own single-goal problem:

  - exact tier: points mode against each object's voxel-downsampled scene
    point sets (host numpy from its depth image), 12 single-pass
    iterations at obstacle weight 40; two K2 launches per pass for the
    whole batch;
  - rescue tier: field mode at the main planner's flavor, on the per-object
    stacked tables of phase 1;
  - each tier's clearance: the minimum signed distance of its plans' body
    points to the obstacle set, resting contacts at the start left out
    (one K3 launch for both tiers).

Here both tiers run over every object of the batch, as a throughput
measure; the closed-loop pipeline (planning/pipeline.py) runs them only
for objects whose plan fails its replay scorer.

Observations come from the synthetic tabletop scenes on the host
(`collect_observations`); everything after that runs on one device.

    python -m grasptrajopt_tpu_torch.e2e [--device cuda|cpu] [--batch 16] [--reps 3]
        [--ik_iterations 24] [--coherence 0] [--rescue_k 1]

runs the phases on the synthetic arm (float32, 100 points per link, its
gripper model), once to warm up and `reps` times, and prints one JSON
line: ms per object a phase of the fastest run (host clock around
synchronized phases), the rescues applied and the gates.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from grasptrajopt_tpu_torch.convert import scene_sets_from_numpy
from grasptrajopt_tpu_torch.envs.synthetic import SyntheticSceneEnv
from grasptrajopt_tpu_torch.fields.depth_point_cloud import (
    DepthPointCloud,
    TwoCostFields,
    build_two_cost_fields,
    first_true_indices,
    signed_distance_to_cloud,
)
from grasptrajopt_tpu_torch.fields.scene_points import scene_point_sets_from_depth
from grasptrajopt_tpu_torch.ops import interp, nn
from grasptrajopt_tpu_torch.planning.evaluate import check_plan_collision
from grasptrajopt_tpu_torch.planning.gto_models import GTORobotModel
from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner
from grasptrajopt_tpu_torch.planning.ik_solver import IKSolver
from grasptrajopt_tpu_torch.planning.utils import interpolate_waypoints
from grasptrajopt_tpu_torch.spatial import qangle_deg, r2quat, standoff, transform_points
from grasptrajopt_tpu_torch.testing import (
    SYNTH_DEFAULT_POSE,
    SYNTH_EVAL_CONFIG,
    SYNTH_LINK_EE,
    SYNTH_LINK_GRIPPER,
)


@dataclass(frozen=True)
class SliceConfig:
    """The perception-to-plan path at bench_e2e.py's defaults for an arm of
    the panda's flavour (`bench_e2e.py:47-100`)."""

    batch: int = 16  # objects
    goal_capacity: int = 32  # grasps per object
    width: int = 160
    height: int = 160
    scenes: Tuple[int, ...] = (10, 36, 48, 65)
    depth_threshold: float = 1.5
    field_epsilon: float = 0.02
    dedup_voxel: float = 0.01
    capacity_obstacle: int = 12288
    capacity_target: int = 2048
    filter_standoff: float = -0.01  # pre-filter pose: grasp @ standoff(-1 cm)
    ik_iterations: int = 24
    ik_seeds: int = 8  # the start pose and 7 random restarts a goal
    ik_seed: int = 0  # the restarts' generator seed
    rank_t_stride: int = 4  # warm-start ranking: every 4th step ...
    rank_p_stride: int = 4  # ... and every 4th body point
    goal_coherence: float = 0.0  # 0: the plain masked argmin of the goal set
    rescue_k: int = 1  # objects re-solved goal by goal (0: no rescue)
    T: int = 50
    plan_iterations: int = 3
    coarse_iterations: int = 2
    final_trust: bool = True
    standoff_distance: float = -0.1
    axis_standoff: str = "z"
    # the per-goal exact tier (the JAX pipeline's escalation defaults)
    exact_iterations: int = 12  # max(12, plan_iterations)
    exact_obstacle_weight: float = 40.0
    exact_points: int = 4096  # obstacle set capacity
    exact_target_points: int = 1024
    exact_resolution: float = 0.02  # voxel of the downsample

    @property
    def exact_epsilon(self) -> float:
        """The field band widened by half a downsample voxel."""
        return self.field_epsilon + 0.5 * self.exact_resolution


@dataclass
class Observations:
    """Host numpy observations of `batch` objects."""

    depth: np.ndarray  # (B, H, W) float32 meters
    target_mask: np.ndarray  # (B, H, W) bool
    cam_pose: np.ndarray  # (B, 4, 4) world-from-camera
    K: np.ndarray  # (3, 3)
    grasps_world: np.ndarray  # (B, G, 4, 4) end-effector poses
    base_position: np.ndarray  # (3,) robot base in the world
    names: List[str]


def collect_observations(cfg: SliceConfig) -> Observations:
    """Objects collected scene-sequentially, nearest first, each one
    removed after its observation (the closed-loop order); the batch is
    padded by repeating the first object."""
    env = SyntheticSceneEnv(
        robot_name="panda", scene_type="tabletop", n_objects=5,
        width=cfg.width, height=cfg.height, depth_threshold=cfg.depth_threshold,
    )
    depths, masks, poses, grasps, names = [], [], [], [], []
    K = None
    for scene_id in cfg.scenes:
        if len(depths) >= cfg.batch:
            break
        meta = env.setup_scene(scene_id)
        env.reset_scene()
        for name in meta["nearest_first"].split(","):
            uid = env._placed(name).uid
            depth, ids, cam_pose, K = env.get_observation()
            depths.append(np.asarray(depth, np.float32))
            masks.append(np.asarray(ids == uid))
            poses.append(np.asarray(cam_pose))
            # the grasp set repeated up to the goal capacity (the env's own
            # tiling), or its first goal_capacity grasps when it is larger
            world = env.grasps_world(name)
            reps = -(-cfg.goal_capacity // world.shape[0])
            grasps.append(np.tile(world, (reps, 1, 1))[: cfg.goal_capacity])
            names.append(f"{scene_id}/{name}")
            env.remove_object(name)
            if len(depths) >= cfg.batch:
                break
    while len(depths) < cfg.batch:
        depths.append(depths[0]); masks.append(masks[0]); poses.append(poses[0])
        grasps.append(grasps[0]); names.append(names[0] + "(pad)")
    return Observations(
        np.stack(depths), np.stack(masks), np.stack(poses), np.asarray(K),
        np.stack(grasps), np.asarray(env.base_position, np.float64), names,
    )


def goal_errors(robot, link_ee, Q_full, tf_goal):
    """(d (B, G) m, rot (B, G) deg): each problem's final end-effector pose
    against each of its goals. Q_full (B, T, ndof); tf_goal (B, G, 4, 4)
    base frame."""
    T_end = robot.get_global_link_transform(link_ee, Q_full[:, -1])
    d = torch.linalg.vector_norm(tf_goal[..., :3, 3] - T_end[:, None, :3, 3], dim=-1)
    rot = qangle_deg(r2quat(tf_goal[..., :3, :3]), r2quat(T_end[:, None, :3, :3]))
    return d, rot


def reach_error(robot, link_ee, Q_full, tf_goal, goal_mask):
    """(B,) each problem's best d + 2e-3 x rot over its kept goals (the
    rescue's selection metric)."""
    d, rot = goal_errors(robot, link_ee, Q_full, tf_goal)
    return torch.amin(torch.where(goal_mask, d + 2e-3 * rot, torch.full_like(d, float("inf"))), dim=1)


def _reached(robot, link_ee, Q_full, tf_goal, goal_mask):
    """Per problem, whether its final pose reaches one of its kept goals
    within the IK gates (1 cm / 5 deg) and within the plan gates (2 cm /
    10 deg). Q_full (B, T, ndof); tf_goal (B, G, 4, 4) base frame."""
    d, rot = goal_errors(robot, link_ee, Q_full, tf_goal)
    strict = ((d < 0.01) & (rot < 5.0) & goal_mask).any(dim=1)
    loose = ((d < 0.02) & (rot < 10.0) & goal_mask).any(dim=1)
    return strict, loose


def pergoal_reach_fractions(robot, link_ee, Q_full, tf_goal, n_goals) -> Dict[str, float]:
    """Share of objects with at least one per-goal plan that reaches its
    own goal under the IK gates and the plan gates. Q_full (C, G, T, ndof);
    tf_goal (C, G, 4, 4) base frame with the n_goals (C,) real goals first."""
    C, G = tf_goal.shape[:2]
    real = torch.arange(G, device=tf_goal.device)[None, :] < n_goals[:, None]
    strict, loose = _reached(
        robot, link_ee, Q_full.reshape((C * G,) + Q_full.shape[2:]),
        tf_goal.reshape(C * G, 1, 4, 4), real.reshape(C * G, 1),
    )
    return {
        "reached_frac_ik_gates": float(strict.reshape(C, G).any(dim=1).float().mean()),
        "reached_frac_plan_gates": float(loose.reshape(C, G).any(dim=1).float().mean()),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PerceptionToPlan:
    """The phases on one device, for the synthetic arm `synth7` and its
    gripper model (testing.make_synthetic_gripper)."""

    def __init__(self, robot: GTORobotModel, gripper: GTORobotModel, cfg: SliceConfig):
        self.robot = robot
        self.cfg = cfg
        dev, dt = robot.device, robot.dtype
        self.grid_pts = torch.as_tensor(robot.grid.grid_points(np.float64), dtype=dt, device=dev)
        self.qc = torch.as_tensor(SYNTH_DEFAULT_POSE, dtype=dt, device=dev)
        self.link_ee = SYNTH_LINK_EE
        pts = gripper.compute_fk_surface_points(SYNTH_EVAL_CONFIG["gripper_open_offsets"])
        self.filter_points = torch.as_tensor(pts, dtype=dt, device=dev)
        self.filter_offset = standoff(cfg.filter_standoff, cfg.axis_standoff, dt, dev)
        self.ik = IKSolver(
            robot, SYNTH_LINK_EE, SYNTH_LINK_GRIPPER, collision_avoidance=False,
            iterations=cfg.ik_iterations, num_seeds=cfg.ik_seeds,
        )
        self.planner = GTOPlanner(
            robot, SYNTH_LINK_EE, SYNTH_LINK_GRIPPER,
            standoff_distance=cfg.standoff_distance, iterations=cfg.plan_iterations,
            T=cfg.T, single_pass=True, coarse_iterations=cfg.coarse_iterations,
            final_trust=cfg.final_trust, sdf_epsilon=cfg.field_epsilon,
            rank_t_stride=cfg.rank_t_stride, rank_p_stride=cfg.rank_p_stride,
            goal_coherence=cfg.goal_coherence,
        )
        self.solvers = self.planner.setup_optimization(
            goal_size=cfg.goal_capacity, use_standoff=True, axis_standoff=cfg.axis_standoff
        )
        # the rescue's single-goal problems
        self.solvers1 = self.planner.setup_optimization(
            goal_size=1, use_standoff=True, axis_standoff=cfg.axis_standoff
        )
        self.exact_planner = GTOPlanner(
            robot, SYNTH_LINK_EE, SYNTH_LINK_GRIPPER, obstacle_mode="points", single_pass=True,
            standoff_distance=cfg.standoff_distance, iterations=cfg.exact_iterations,
            obstacle_weight=cfg.exact_obstacle_weight, sdf_epsilon=cfg.exact_epsilon, T=cfg.T,
        )

    def tensors(self, obs: Observations) -> Dict[str, torch.Tensor]:
        """Observations on the model's device and dtype; goals in both the
        world and the robot base frame."""
        dev, dt = self.robot.device, self.robot.dtype
        tf_world = torch.as_tensor(obs.grasps_world, dtype=dt, device=dev)
        base = torch.as_tensor(obs.base_position, dtype=dt, device=dev)
        shift = torch.zeros(4, 4, dtype=dt, device=dev)
        shift[:3, 3] = base
        return {
            "depth": torch.as_tensor(obs.depth, dtype=dt, device=dev),
            "target_mask": torch.as_tensor(obs.target_mask, device=dev),
            "cam_pose": torch.as_tensor(obs.cam_pose, dtype=dt, device=dev),
            "K": torch.as_tensor(obs.K, dtype=dt, device=dev),
            "tf_world": tf_world,
            "tf_goal": tf_world - shift,
            "base_position": base,
        }

    def filter_queries(self, x: Dict[str, torch.Tensor]):
        """The pre-filter's queries: the gripper points at every grasp's
        standoff pose, (B, G * P, 3) world frame, and the target-masked
        depth image that signs them."""
        B = x["tf_world"].shape[0]
        gp = transform_points(x["tf_world"] @ self.filter_offset, self.filter_points)  # (B, G, P, 3)
        d_obs_img = torch.where(
            x["target_mask"], torch.full_like(x["depth"], self.cfg.depth_threshold), x["depth"]
        )
        return gp.reshape(B, -1, 3), d_obs_img

    def fields(self, x: Dict[str, torch.Tensor]):
        """Phase 1: (tables, base, keep, TwoCostFields)."""
        cfg = self.cfg
        two: TwoCostFields = build_two_cost_fields(
            x["depth"], x["K"], x["cam_pose"], x["target_mask"], self.grid_pts,
            threshold=cfg.depth_threshold, epsilon=cfg.field_epsilon,
            dedup_voxel=cfg.dedup_voxel, capacity_obstacle=cfg.capacity_obstacle,
            capacity_target=cfg.capacity_target,
        )
        tables, base = self.planner.pack_stacked_fields(two.f_all, two.f_obs)
        gp, d_obs_img = self.filter_queries(x)
        sdf = signed_distance_to_cloud(
            gp, two.obs_pts, two.obs_mask, d_obs_img, x["K"], x["cam_pose"]
        ).reshape(x["tf_world"].shape[:2] + (-1,))
        keep = (sdf < 0).to(sdf.dtype).mean(dim=-1) <= 0.01
        return tables, base, keep, two

    def ik_screen(self, x: Dict[str, torch.Tensor]):
        """Phase 2: (found (B, G), err_pos, err_rot, q_sols (B, G, ndof))."""
        B, G = x["tf_goal"].shape[:2]
        q, err_pos, err_rot, _ = self.ik.solve_ik_batch(
            self.qc, x["tf_goal"].reshape(B * G, 4, 4), multistart=True, seed=self.cfg.ik_seed
        )
        err_pos, err_rot = err_pos.reshape(B, G), err_rot.reshape(B, G)
        found = (err_pos < 0.01) & (err_rot < 5.0)
        return found, err_pos, err_rot, q.reshape(B, G, -1)

    def rank(self, x, q_sols, found, f_obs):
        """Phase 3: every IK solution's seed trajectory (B, G, T, ndof),
        scored on each object's target-free field f_obs (B, S) by
        `rank_seed_scores` (goals the screen missed at inf) and picked by
        `rank_pick`. Returns (X0 (B, T-2, n_opt), seed_goal (B,))."""
        robot, planner = self.robot, self.planner
        B = q_sols.shape[0]
        seeds = planner._seed_trajectories(self.qc, q_sols)
        costs, dists = planner.rank_seed_scores(seeds, f_obs, x["base_position"])
        costs = torch.where(found, costs, torch.full_like(costs, float("inf")))
        seed_goal = planner.rank_pick(costs, dists)
        Q0 = seeds[torch.arange(B, device=seeds.device), seed_goal]
        return robot.extract_optimized_dimensions(Q0[:, 2:]), seed_goal

    def plan(self, x, X0, tables, base, goal_mask, seed_goal):
        """Phase 4: (Q (B, T, n_opt), cost (B,), aux)."""
        robot = self.robot
        B = X0.shape[0]
        params = {
            "q_param": robot.extract_parameter_dimensions(self.qc).expand(B, -1),
            "tf_goal": x["tf_goal"],
            "goal_mask": goal_mask,
            "base_position": x["base_position"].expand(B, 3),
            "field_base": base,
        }
        if self.cfg.goal_coherence > 0:
            params["goal_seed"] = seed_goal
        qc_opt = robot.extract_optimized_dimensions(self.qc).expand(B, -1)
        return self.solvers.solve_batch_stacked(qc_opt, X0, params, {"packed_fields": tables})

    def full_q(self, Q):
        """Full-q plans (..., T, ndof) of optimized-joint plans Q."""
        return self.robot.assemble_q(Q, self.robot.extract_parameter_dimensions(self.qc))

    def rescue(self, x, Q, tables, base, goal_mask, q_sols):
        """Phase 5: the rescue_k objects of worst reach error each have all
        their goal slots re-solved as single-goal problems (from each slot's
        IK solution, interpolated from qc), in one batch; each keeps its
        best per-goal plan (reach error against its own goal, slots outside
        the goal mask at inf) where that beats the goal-set plan. Returns
        (Q (B, T, n_opt), worst (K,), better (K,) bool)."""
        robot, cfg = self.robot, self.cfg
        K, G, T = cfg.rescue_k, x["tf_goal"].shape[1], cfg.T
        dev = Q.device
        err0 = reach_error(robot, self.link_ee, self.full_q(Q), x["tf_goal"], goal_mask)
        worst = torch.argsort(-err0, stable=True)[:K]
        tfk = x["tf_goal"][worst].reshape(K * G, 1, 4, 4)
        X0k = robot.extract_optimized_dimensions(
            interpolate_waypoints(self.qc, q_sols[worst].reshape(K * G, -1), T)[:, 2:]
        )
        params = {
            "q_param": robot.extract_parameter_dimensions(self.qc).expand(K * G, -1),
            "tf_goal": tfk,
            "goal_mask": torch.ones((K * G, 1), dtype=torch.bool, device=dev),
            "base_position": x["base_position"].expand(K * G, 3),
            "field_base": base[worst].repeat_interleave(G),
        }
        qc_opt = robot.extract_optimized_dimensions(self.qc).expand(K * G, -1)
        Qr, _, _ = self.solvers1.solve_batch_stacked(qc_opt, X0k, params, {"packed_fields": tables})
        d, rot = goal_errors(robot, self.link_ee, self.full_q(Qr), tfk)  # each against its own goal
        errr = torch.where(goal_mask[worst].reshape(K * G), d[:, 0] + 2e-3 * rot[:, 0],
                           torch.full_like(d[:, 0], float("inf"))).reshape(K, G)
        bestg = torch.argmin(errr, dim=1)
        better = errr[torch.arange(K, device=dev), bestg] < err0[worst]
        Q_repl = Qr.reshape(K, G, T, -1)[torch.arange(K, device=dev), bestg]
        Q = Q.clone()
        Q[worst] = torch.where(better[:, None, None], Q_repl, Q[worst])
        return Q, worst, better

    def run(self, obs: Observations) -> Dict:
        """The five phases; host-clock seconds per phase after a device
        synchronize."""
        dev = self.robot.device
        x = self.tensors(obs)
        marks = [time.perf_counter()]

        def mark():
            _sync(dev)
            marks.append(time.perf_counter())

        _sync(dev)
        marks[0] = time.perf_counter()
        tables, base, keep, two = self.fields(x)
        mark()
        found, err_pos, err_rot, q_sols = self.ik_screen(x)
        mark()
        X0, seed_goal = self.rank(x, q_sols, found, two.f_obs)
        mark()
        goal_mask = keep & found
        goal_mask = torch.where(goal_mask.any(dim=1, keepdim=True), goal_mask, torch.ones_like(goal_mask))
        Q_plan, cost, aux = self.plan(x, X0, tables, base, goal_mask, seed_goal)
        mark()
        if self.cfg.rescue_k:
            Q, worst, rescued = self.rescue(x, Q_plan, tables, base, goal_mask, q_sols)
        else:
            Q = Q_plan
            worst = rescued = torch.zeros((0,), dtype=torch.bool, device=dev)
        mark()
        seconds = dict(zip(("fields", "ik", "rank", "plan", "rescue"), np.diff(marks).tolist()))
        return {
            "inputs": x, "fields": two, "tables": tables, "field_base": base, "keep": keep,
            "X0": X0, "seed_goal": seed_goal, "found": found, "err_pos": err_pos, "err_rot": err_rot,
            "q_sols": q_sols, "goal_mask": goal_mask, "Q_plan": Q_plan, "Q": Q, "cost": cost, "aux": aux,
            "worst": worst, "rescued": rescued, "seconds": seconds,
        }

    def gates(self, obs: Observations, out: Dict) -> Dict[str, float]:
        """bench_e2e.py's gates of the final plans (untimed): reach within
        the IK gates (1 cm / 5 deg) and the plan gates (2 cm / 10 deg) over
        the kept goals; the errors at each object's best goal; the share of
        plans whose replay collides with the object's obstacle cloud (more
        than 5 body points inside at a step beyond those inside at step 0;
        planning/evaluate.py, one K1 launch an object); the grasps kept and
        the IK found rates."""
        robot, cfg = self.robot, self.cfg
        x, gm = out["inputs"], out["goal_mask"]
        Q_full = self.full_q(out["Q"])
        strict, loose = _reached(robot, self.link_ee, Q_full, x["tf_goal"], gm)
        d, rot = goal_errors(robot, self.link_ee, Q_full, x["tf_goal"])
        best = torch.argmin(torch.where(gm, d + 2e-3 * rot, torch.full_like(d, float("inf"))), dim=1)
        rows = torch.arange(d.shape[0], device=d.device)
        err_pos, err_rot = d[rows, best].cpu().numpy(), rot[rows, best].cpu().numpy()
        plans = Q_full.transpose(1, 2).cpu().numpy()  # (B, ndof, T)
        collisions = []
        for b in range(plans.shape[0]):
            d_obs = np.where(obs.target_mask[b], cfg.depth_threshold, obs.depth[b])
            cloud = DepthPointCloud(d_obs, obs.K, obs.cam_pose[b], obs.target_mask[b],
                                    threshold=cfg.depth_threshold, device=robot.device)
            collisions.append(check_plan_collision(robot, plans[b], cloud, obs.base_position)[0])
        return {
            "reached_frac_ik_gates": float(strict.double().mean()),
            "reached_frac_plan_gates": float(loose.double().mean()),
            "collision_frac": float(np.mean(collisions)),
            "err_pos_median": float(np.median(err_pos)),
            "err_pos_p90": float(np.quantile(err_pos, 0.9)),
            "err_rot_median_deg": float(np.median(err_rot)),
            "err_rot_p90_deg": float(np.quantile(err_rot, 0.9)),
            "mean_grasps_kept": float(out["keep"].double().mean()),
            "mean_ik_found": float(out["found"].double().mean()),
        }

    def scene_sets(self, obs: Observations) -> Dict[str, torch.Tensor]:
        """The exact tier's per-object scene point sets on the host (the
        JAX pipeline's settings), stacked (C, K, 3) on the device."""
        cfg = self.cfg
        sets = [
            scene_point_sets_from_depth(
                obs.depth[b], obs.K, obs.cam_pose[b], obs.target_mask[b],
                capacity_obstacle=cfg.exact_points, capacity_target=cfg.exact_target_points,
                depth_threshold=cfg.depth_threshold, resolution=cfg.exact_resolution,
            )
            for b in range(obs.depth.shape[0])
        ]
        return scene_sets_from_numpy(
            [o for o, _ in sets], [t for _, t in sets], self.robot.device, self.robot.dtype
        )

    def clearance(self, Q_full, sets, base_position):
        """(C, G) minimum signed distance of each plan's body points
        Q_full (C, G, T, ndof) to its object's obstacle set: one K3 launch
        (distance and index under the set's validity mask), the sign from
        the nearest sample's normal as in points mode. Points already
        inside at step 0 are left out, as the JAX replay scorer leaves out
        such resting contacts (planning/evaluate.py check_plan_collision)."""
        C = Q_full.shape[0]
        pts = self.robot.fk_surface_points(Q_full, base_position)  # (C, G, T, P, 3)
        q = pts.reshape(C, -1, 3)
        d2, idx = nn.min_sqdist(q, sets["scene_points"], sets["scene_mask"])
        rows = idx.long()[..., None].expand(q.shape)
        nearest = torch.gather(sets["scene_points"], 1, rows)
        normal = torch.gather(sets["scene_normals"], 1, rows)
        sd, _ = nn.signed_distance_from_nearest(q, d2, nearest, normal)
        sd = sd.reshape(pts.shape[:-1])
        resting = sd[..., :1, :] < 0  # inside at step 0
        return torch.where(resting, torch.full_like(sd, float("inf")), sd).amin(dim=(-2, -1))

    def pergoal(self, obs: Observations, out: Dict) -> Dict:
        """The per-goal tiers after the slice's IK screen (`run`'s output):
        each object's kept and found goal slots compacted to the front (all
        slots where none survives), one single-goal problem per slot, each
        starting from its own IK solution. Host-clock seconds per part
        after a device synchronize."""
        cfg, robot = self.cfg, self.robot
        dev = robot.device
        x = out["inputs"]
        B, G = out["goal_mask"].shape
        _sync(dev)
        t0 = time.perf_counter()
        sets = self.scene_sets(obs)
        order, _ = first_true_indices(out["goal_mask"], G)
        n_goals = out["goal_mask"].sum(dim=1)
        tf_goal = torch.gather(x["tf_goal"], 1, order[..., None, None].expand(B, G, 4, 4))
        q_sols = torch.gather(out["q_sols"], 1, order[..., None].expand(out["q_sols"].shape))
        base = x["base_position"]
        _sync(dev)
        t1 = time.perf_counter()
        k4 = interp.field_lookup_launches
        Q_exact, cost_exact, _ = self.exact_planner.plan_pergoal_batch(
            self.qc, tf_goal, n_goals, q_sols, base, True, cfg.axis_standoff, scene=sets,
        )
        _sync(dev)
        t2 = time.perf_counter()
        k4_exact = interp.field_lookup_launches - k4
        Q_rescue, cost_rescue, _ = self.planner.plan_pergoal_batch(
            self.qc, tf_goal, n_goals, q_sols, base, True, cfg.axis_standoff,
            fields=(out["tables"], out["field_base"]),
        )
        _sync(dev)
        t3 = time.perf_counter()
        k4_rescue = interp.field_lookup_launches - k4 - k4_exact
        Q_both = torch.stack([Q_exact, Q_rescue], dim=1)  # (C, 2, G, T, ndof)
        sd = self.clearance(Q_both.reshape((B, 2 * G) + Q_both.shape[3:]), sets, base)
        _sync(dev)
        t4 = time.perf_counter()
        sd = sd.reshape(B, 2, G)
        return {
            "sets": sets, "tf_goal": tf_goal, "n_goals": n_goals, "q_sols": q_sols,
            "Q_exact": Q_exact, "cost_exact": cost_exact,
            "Q_rescue": Q_rescue, "cost_rescue": cost_rescue,
            "sd_exact": sd[:, 0], "sd_rescue": sd[:, 1],
            "seconds": {"scene_sets": t1 - t0, "exact": t2 - t1, "rescue": t3 - t2, "clearance": t4 - t3},
            "field_lookup_launches": {"exact": k4_exact, "rescue": k4_rescue},
        }


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description="bench_e2e.py's phases on the port")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=SliceConfig.batch)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ik_iterations", type=int, default=SliceConfig.ik_iterations)
    ap.add_argument("--coherence", type=float, default=SliceConfig.goal_coherence)
    ap.add_argument("--rescue_k", type=int, default=SliceConfig.rescue_k)
    args = ap.parse_args(argv)
    from grasptrajopt_tpu_torch.testing import make_synthetic_gripper, make_synthetic_gto_robot

    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(
        SliceConfig(), batch=args.batch, ik_iterations=args.ik_iterations, goal_coherence=args.coherence,
        rescue_k=args.rescue_k,
    )
    robot = make_synthetic_gto_robot(device=dev, dtype=torch.float32, points_per_link=100)
    gripper = make_synthetic_gripper(device=dev, dtype=torch.float32, points_per_link=100)
    path = PerceptionToPlan(robot, gripper, cfg)
    obs = collect_observations(cfg)
    path.run(obs)  # warm-up
    runs = [path.run(obs) for _ in range(args.reps)]
    best = min(runs, key=lambda r: sum(r["seconds"].values()))
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "config": dataclasses.asdict(cfg),
        "phase_ms_per_object": {k: 1e3 * v / cfg.batch for k, v in best["seconds"].items()},
        "objects_per_s": cfg.batch / sum(best["seconds"].values()),
        "rescue": {"k": cfg.rescue_k, "applied": int(best["rescued"].sum())},
        "gates": path.gates(obs, best),
    }


if __name__ == "__main__":
    print(json.dumps(main()))
