"""The perception-to-plan path, batch-first: depth images in, plans out.

Mirrors the JAX package's end-to-end benchmark chain (bench_e2e.py,
fields -> IK -> plan) on the port:

  1. fields: per observation, the voxel-deduplicated obstacle cloud and
     the target pixels -> the scene and target-free obstacle cost fields
     on the workspace grid (two K1 launches for the whole batch), packed
     into one stacked corner table; then the grasp pre-filter: the gripper
     link's surface points at every grasp's standoff pose against the
     obstacle cloud (one more K1 launch);
  2. IK screen: one single-seed projected-LM batch over every grasp of
     every object, gated at 1 cm / 5 degrees; the warm start interpolates
     to each object's lowest err_pos + 2e-3 * err_rot IK solution;
  3. plan: the goal-set trajectory solve over per-problem stacked fields,
     goal slots = pre-filter keep & IK found (all slots where none
     survives).

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

The JAX pipeline runs these tiers only for objects whose plan fails its
replay scorer (planning/evaluate.py, not ported yet), so here both run
over every object.

Observations come from the synthetic tabletop scenes on the host
(`collect_observations`); everything after that runs on one device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from grasptrajopt_tpu_torch.convert import scene_sets_from_numpy
from grasptrajopt_tpu_torch.envs.synthetic import SyntheticSceneEnv
from grasptrajopt_tpu_torch.fields.depth_point_cloud import (
    TwoCostFields,
    build_two_cost_fields,
    first_true_indices,
    signed_distance_to_cloud,
)
from grasptrajopt_tpu_torch.fields.scene_points import scene_point_sets_from_depth
from grasptrajopt_tpu_torch.ops import interp, nn
from grasptrajopt_tpu_torch.planning.gto_models import GTORobotModel
from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner
from grasptrajopt_tpu_torch.planning.ik_solver import IKSolver
from grasptrajopt_tpu_torch.planning.utils import interpolate_waypoints
from grasptrajopt_tpu_torch.spatial import qangle_deg, r2quat, standoff, transform_points
from grasptrajopt_tpu_torch.testing import SYNTH_DEFAULT_POSE, SYNTH_LINK_EE, SYNTH_LINK_GRIPPER


@dataclass(frozen=True)
class SliceConfig:
    """The perception-to-plan path at the JAX benchmark's panda flavor."""

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
    ik_iterations: int = 50
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


def _reached(robot, link_ee, Q_full, tf_goal, goal_mask):
    """Per problem, whether its final pose reaches one of its kept goals
    within the IK gates (1 cm / 5 deg) and within the plan gates (2 cm /
    10 deg). Q_full (B, T, ndof); tf_goal (B, G, 4, 4) base frame."""
    T_end = robot.get_global_link_transform(link_ee, Q_full[:, -1])
    d = torch.linalg.vector_norm(tf_goal[..., :3, 3] - T_end[:, None, :3, 3], dim=-1)
    rot = qangle_deg(r2quat(tf_goal[..., :3, :3]), r2quat(T_end[:, None, :3, :3]))
    strict = ((d < 0.01) & (rot < 5.0) & goal_mask).any(dim=1)
    loose = ((d < 0.02) & (rot < 10.0) & goal_mask).any(dim=1)
    return strict, loose


def reach_fractions(robot, link_ee, Q_full, tf_goal, goal_mask) -> Dict[str, float]:
    """Share of objects whose final pose reaches one of their kept goals
    under the IK gates and the plan gates (see `_reached`)."""
    strict, loose = _reached(robot, link_ee, Q_full, tf_goal, goal_mask)
    return {
        "reached_frac_ik_gates": float(strict.float().mean()),
        "reached_frac_plan_gates": float(loose.float().mean()),
    }


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
    """The three phases on one device, for the synthetic arm `synth7`."""

    def __init__(self, robot: GTORobotModel, cfg: SliceConfig):
        self.robot = robot
        self.cfg = cfg
        dev, dt = robot.device, robot.dtype
        self.grid_pts = torch.as_tensor(robot.grid.grid_points(np.float64), dtype=dt, device=dev)
        self.qc = torch.as_tensor(SYNTH_DEFAULT_POSE, dtype=dt, device=dev)
        self.link_ee = SYNTH_LINK_EE
        # the synthetic arm has no separate gripper model: the pre-filter
        # uses the hand link's surface points, the points the planner matches
        self.filter_points = robot.gripper_points(SYNTH_LINK_GRIPPER)
        self.filter_offset = standoff(cfg.filter_standoff, cfg.axis_standoff, dt, dev)
        self.ik = IKSolver(robot, SYNTH_LINK_EE, SYNTH_LINK_GRIPPER, iterations=cfg.ik_iterations)
        self.planner = GTOPlanner(
            robot, SYNTH_LINK_EE, SYNTH_LINK_GRIPPER,
            standoff_distance=cfg.standoff_distance, iterations=cfg.plan_iterations,
            T=cfg.T, single_pass=True, coarse_iterations=cfg.coarse_iterations,
            final_trust=cfg.final_trust, sdf_epsilon=cfg.field_epsilon,
        )
        self.solvers = self.planner.setup_optimization(
            goal_size=cfg.goal_capacity, use_standoff=True, axis_standoff=cfg.axis_standoff
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
        """Phase 2: (X0 (B, T-2, n_opt), found (B, G), err_pos, err_rot,
        q_sols (B, G, ndof))."""
        robot = self.robot
        B, G = x["tf_goal"].shape[:2]
        q, err_pos, err_rot = self.ik.solve_ik_batch(self.qc, x["tf_goal"].reshape(B * G, 4, 4))
        err_pos, err_rot = err_pos.reshape(B, G), err_rot.reshape(B, G)
        found = (err_pos < 0.01) & (err_rot < 5.0)
        q_sols = q.reshape(B, G, -1)
        warm = torch.argmin(err_pos + 2e-3 * err_rot, dim=1)
        q_best = q_sols[torch.arange(B, device=q.device), warm]
        X0 = robot.extract_optimized_dimensions(interpolate_waypoints(self.qc, q_best, self.cfg.T - 2))
        return X0, found, err_pos, err_rot, q_sols

    def plan(self, x, X0, tables, base, goal_mask):
        """Phase 3: (Q (B, T, n_opt), cost (B,), aux)."""
        robot = self.robot
        B = X0.shape[0]
        params = {
            "q_param": robot.extract_parameter_dimensions(self.qc).expand(B, -1),
            "tf_goal": x["tf_goal"],
            "goal_mask": goal_mask,
            "base_position": x["base_position"].expand(B, 3),
            "field_base": base,
        }
        qc_opt = robot.extract_optimized_dimensions(self.qc).expand(B, -1)
        return self.solvers.solve_batch_stacked(qc_opt, X0, params, {"packed_fields": tables})

    def run(self, obs: Observations) -> Dict:
        """All three phases; host-clock seconds per phase after a device
        synchronize."""
        dev = self.robot.device
        x = self.tensors(obs)
        _sync(dev)
        t0 = time.perf_counter()
        tables, base, keep, two = self.fields(x)
        _sync(dev)
        t1 = time.perf_counter()
        X0, found, err_pos, err_rot, q_sols = self.ik_screen(x)
        _sync(dev)
        t2 = time.perf_counter()
        goal_mask = keep & found
        goal_mask = torch.where(goal_mask.any(dim=1, keepdim=True), goal_mask, torch.ones_like(goal_mask))
        Q, cost, aux = self.plan(x, X0, tables, base, goal_mask)
        _sync(dev)
        t3 = time.perf_counter()
        return {
            "inputs": x, "fields": two, "tables": tables, "field_base": base, "keep": keep,
            "X0": X0, "found": found, "err_pos": err_pos, "err_rot": err_rot, "q_sols": q_sols,
            "goal_mask": goal_mask, "Q": Q, "cost": cost, "aux": aux,
            "seconds": {"fields": t1 - t0, "ik": t2 - t1, "plan": t3 - t2},
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
