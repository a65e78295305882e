"""GraspPipeline: the per-object planning pipeline, field mode.

Port of grasptrajopt_tpu/planning/pipeline.py: depth observation (one
view, or several fused) -> two SDF cost fields -> grasp-set collision
pre-filter -> multistart IK screen -> goal-set plan, then the replay
scorer's gates (planning/evaluate.py) decide what follows: a per-goal
field rescue when the plan fails them, then the escalation tiers in
failure-mode order (the exact-geometry points-mode re-solve for a
colliding best plan, the deeper field re-solve for a clean miss), and the
safe-decline truncation when every candidate still collides.

On the card: the two field builds and the pre-filter are one K1 launch
each, every replay scoring one more; the goal-set plan and the rescue
launch K4, the deep tier K4, the exact tier K2.

Host-facing arguments and returns keep the JAX package's layout: numpy
plans (ndof, T) and batches (n, ndof, T). The IK screen's gate is reach
within 1 cm / 5 degrees and, with `ik_collision_avoidance` (the obstacle
term in the IK cost, K4 on the card), a collision cost below
`ik_collision_threshold`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from grasptrajopt_tpu_torch.convert import scene_sets_from_numpy
from grasptrajopt_tpu_torch.fields.depth_point_cloud import DepthPointCloud, FusedDepthPointCloud
from grasptrajopt_tpu_torch.fields.scene_points import scene_point_sets_from_depth
from grasptrajopt_tpu_torch.planning import evaluate
from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner
from grasptrajopt_tpu_torch.planning.ik_solver import IKSolver
from grasptrajopt_tpu_torch.spatial import transform_points


@dataclass
class PipelineResult:
    plan: Optional[np.ndarray]  # (ndof, T) or None at the stage that failed
    dQ: Optional[np.ndarray]
    cost: Optional[float]
    n_grasps: int
    n_collision_free: int
    n_ik_found: int
    checking_time: float
    ik_time: float
    planning_time: float
    stage: str  # 'ok' | 'no_collision_free_grasp' | 'no_ik'
    # a per-goal re-solve (rescue, escalation or truncation) produced the plan
    rescued: bool = False
    # an escalation tier (exact or deep) produced the plan
    escalated: bool = False


class GraspPipeline:
    def __init__(
        self,
        robot,
        gripper_model,
        link_ee: str,
        link_gripper: str,
        axis_standoff: str = "x",
        gripper_open_offsets=(0.04, 0.04),
        standoff_distance: float = -0.1,
        standoff_offset: int = -10,
        ik_collision_avoidance: bool = False,
        ik_collision_threshold: float = 5.0,
        collision_filter_offset: float = -0.01,
        collision_filter_ratio: float = 0.01,
        interpolate: bool = True,
        use_ik_standoff: bool = False,
        goal_capacity: int = 64,
        depth_threshold: float = 1.5,
        grid=None,
        ik_capacity: Optional[int] = None,
        planner_iterations: int = 50,
        planner_single_pass: bool = False,
        planner_coarse_iterations: int = 0,
        planner_coarse_stride: int = 2,
        planner_final_trust: bool = False,
        planner_rank_t_stride: int = 1,
        planner_rank_p_stride: int = 1,
        ik_iterations: int = 50,
        ik_num_seeds: int = 8,
        rescue: bool = True,
        rescue_pos_tol: float = 0.02,
        rescue_rot_tol_deg: float = 10.0,
        goal_weight: float = 1.0,
        field_epsilon: float = 0.02,
        field_downsample: Optional[float] = None,
        escalate: bool = True,
        escalate_obstacle_weight: float = 40.0,
        escalate_points_capacity: int = 4096,
        escalate_target_capacity: int = 1024,
        escalate_resolution: float = 0.02,
        escalate_epsilon: Optional[float] = None,
        escalate_iterations: Optional[int] = None,
        plan_views: Optional[int] = None,
    ):
        """See the JAX package's GraspPipeline for each knob. grid: a
        fixed VoxelGrid for every object (None: the bounds of each
        observation's cloud); field_downsample: the voxel (m) of the
        dense field builds' cloud (the filter and the scorer keep the full
        cloud); plan_views: the planning fields and the grasp filter use
        the first N views, the replay scorer all of them (None: all)."""
        self.robot = robot
        self.gripper_model = gripper_model
        self.link_ee = link_ee
        self.link_gripper = link_gripper
        self.axis_standoff = axis_standoff
        self.gripper_open_offsets = np.asarray(gripper_open_offsets)
        self.standoff_distance = standoff_distance
        self.collision_filter_offset = collision_filter_offset
        self.collision_filter_ratio = collision_filter_ratio
        self.ik_collision_threshold = ik_collision_threshold
        self.interpolate = interpolate
        self.use_ik_standoff = use_ik_standoff
        self.goal_capacity = goal_capacity
        self.depth_threshold = depth_threshold
        self.grid = grid
        self.ik_capacity = ik_capacity
        self.rescue = rescue
        self.rescue_pos_tol = rescue_pos_tol
        self.rescue_rot_tol_deg = rescue_rot_tol_deg
        self.field_epsilon = float(field_epsilon)
        self.field_downsample = field_downsample
        self.escalate = escalate
        self.escalate_obstacle_weight = escalate_obstacle_weight
        self.escalate_points_capacity = escalate_points_capacity
        self.escalate_target_capacity = escalate_target_capacity
        self.escalate_resolution = escalate_resolution
        # the escalation tiers run once per failing trial, so they afford a
        # deeper LM budget than the main plan's
        self.escalate_iterations = (
            escalate_iterations if escalate_iterations is not None else max(12, planner_iterations)
        )
        self.plan_views = plan_views
        # the exact tier's solver sees distances to the DEDUPED set, up to
        # half a dedup voxel larger than the scorer's: its band is widened
        # by that much
        self.escalate_epsilon = (
            escalate_epsilon if escalate_epsilon is not None else field_epsilon + 0.5 * escalate_resolution
        )
        self.planner = GTOPlanner(
            robot, link_ee, link_gripper,
            standoff_distance=standoff_distance, standoff_offset=standoff_offset,
            iterations=planner_iterations, goal_weight=goal_weight,
            single_pass=planner_single_pass,
            coarse_iterations=planner_coarse_iterations,
            coarse_stride=planner_coarse_stride,
            final_trust=planner_final_trust,
            rank_t_stride=planner_rank_t_stride,
            rank_p_stride=planner_rank_p_stride,
        )
        self._planner_exact: Optional[GTOPlanner] = None
        self._planner_deep: Optional[GTOPlanner] = None
        self.ik_solver = IKSolver(
            robot, link_ee, link_gripper, collision_avoidance=ik_collision_avoidance,
            iterations=ik_iterations, num_seeds=ik_num_seeds,
        )
        self._gripper_pts = None
        self._plan_pc_obstacle = None

    def _now(self) -> float:
        """Host clock after the device has finished the queued work."""
        if self.robot.device.type == "cuda":
            torch.cuda.synchronize(self.robot.device)
        return time.perf_counter()

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.robot.dtype, device=self.robot.device)

    # -- stages ---------------------------------------------------------------

    @staticmethod
    def _as_views(depth, cam_pose, target_mask):
        """One observation or same-length sequences of them (one entry per
        camera, K shared) as lists."""
        if isinstance(depth, (list, tuple)):
            return [np.asarray(d) for d in depth], list(cam_pose), [np.asarray(m) for m in target_mask]
        return [np.asarray(depth)], [cam_pose], [np.asarray(target_mask)]

    def _cloud(self, depth, K, cam_pose, target_mask=None):
        return DepthPointCloud(
            depth, K, cam_pose, target_mask, threshold=self.depth_threshold, device=self.robot.device
        )

    @staticmethod
    def _fuse(views):
        return views[0] if len(views) == 1 else FusedDepthPointCloud(views)

    def build_fields(self, depth, K, cam_pose, target_mask):
        """The scene and target-free obstacle cost fields (flat (S,)
        float32 tensors) on the grid, one K1 launch each. Returns
        (depth_pc, depth_pc_obstacle, sdf_cost_all, sdf_cost_obstacle); the
        two clouds fuse every view (the replay scorer's)."""
        depths, poses, masks = self._as_views(depth, cam_pose, target_mask)
        n_plan = self.plan_views or len(depths)
        depth_pc = self._fuse([self._cloud(d, K, p) for d, p in zip(depths, poses)])
        if self.grid is not None:
            grid = self.robot.grid = self.grid
        else:
            grid = self.robot.setup_points_field(depth_pc.points)

        def dense(dpc):
            return dpc.downsampled(self.field_downsample) if self.field_downsample else dpc

        # planning fields from the first plan_views views: space those
        # cameras cannot see stays occupied
        plan_pc_all = (
            self._fuse([self._cloud(d, K, p) for d, p in zip(depths[:n_plan], poses[:n_plan])])
            if n_plan < len(depths) else depth_pc
        )
        sdf_cost_all = dense(plan_pc_all).build_cost_field(grid, epsilon=self.field_epsilon)

        def obstacle_fuse(views):
            clouds = []
            for d, p, m in views:
                d_obs = np.array(d, copy=True)
                d_obs[m] = self.depth_threshold
                clouds.append(self._cloud(d_obs, K, p, m))
            return self._fuse(clouds)

        depth_pc_obstacle = obstacle_fuse(zip(depths, poses, masks))
        plan_pc_obstacle = (
            obstacle_fuse(zip(depths[:n_plan], poses[:n_plan], masks[:n_plan]))
            if n_plan < len(depths) else depth_pc_obstacle
        )
        sdf_cost_obstacle = dense(plan_pc_obstacle).build_cost_field(grid, epsilon=self.field_epsilon)
        # the grasp pre-filter is a planning decision too: it uses the
        # planning views' cloud; the replay scorer gates whatever is planned
        self._plan_pc_obstacle = plan_pc_obstacle
        self.ik_solver.setup_optimization(grid)
        return depth_pc, depth_pc_obstacle, sdf_cost_all, sdf_cost_obstacle

    def filter_grasps(self, RT_grasps_world, depth_pc_obstacle) -> np.ndarray:
        """(n,) bool: grasps whose open gripper, at the filter's standoff,
        has at most `collision_filter_ratio` of its surface points inside
        the cloud. One K1 launch for the whole grasp set."""
        dev = depth_pc_obstacle.device
        if self._gripper_pts is None:
            pts_local = self.gripper_model.compute_fk_surface_points(self.gripper_open_offsets)
            self._gripper_pts = torch.as_tensor(pts_local, dtype=torch.float32, device=dev)
        RT_offs = np.asarray(RT_grasps_world) @ self.robot.get_standoff_pose(
            self.collision_filter_offset, self.axis_standoff
        )
        pts = transform_points(torch.as_tensor(RT_offs, dtype=torch.float32, device=dev), self._gripper_pts)
        n, P, _ = pts.shape
        sdf = depth_pc_obstacle.get_sdf(pts.reshape(-1, 3)).reshape(n, P).cpu().numpy()
        return (sdf < 0).mean(axis=1) <= self.collision_filter_ratio

    def screen_ik(self, q0, RT_grasps_base, sdf_cost_obstacle=None, base_position=(0.0, 0.0, 0.0)):
        """Multistart IK over the grasp set (base frame), padded by tiling
        to `ik_capacity`; with the IK collision term, against the obstacle
        field sdf_cost_obstacle (flat, on the IK solver's grid). Returns
        host (q (n, ndof), found (n,))."""
        RT_ik = np.asarray(RT_grasps_base)
        if self.use_ik_standoff:
            RT_ik = RT_ik @ self.robot.get_standoff_pose(self.standoff_distance, self.axis_standoff)
        n = RT_ik.shape[0]
        if self.ik_capacity is not None and n < self.ik_capacity:
            reps = int(np.ceil(self.ik_capacity / n))
            RT_ik = np.tile(RT_ik, (reps, 1, 1))[: self.ik_capacity]
        q, err_pos, err_rot, col = self.ik_solver.solve_ik_batch(
            self._tensor(np.asarray(q0)), self._tensor(RT_ik), sdf_cost_obstacle, base_position,
            multistart=True,
        )
        q, err_pos, err_rot, col = (a[:n].cpu().numpy() for a in (q, err_pos, err_rot, col))
        return q, (err_pos < 0.01) & (err_rot < 5.0) & (col < self.ik_collision_threshold)

    # -- the per-object pipeline ----------------------------------------------

    def plan_object(
        self, qc, depth, K, cam_pose, target_mask, RT_grasps_world, base_position=(0.0, 0.0, 0.0),
    ) -> PipelineResult:
        qc = np.asarray(qc)
        t0 = self._now()
        _, depth_pc_obstacle, sdf_all, sdf_obs = self.build_fields(depth, K, cam_pose, target_mask)
        keep = self.filter_grasps(RT_grasps_world, self._plan_pc_obstacle)
        checking_time = self._now() - t0
        n_grasps = len(keep)
        RT_base = np.asarray(RT_grasps_world)[keep].copy()
        RT_base[:, :3, 3] -= np.asarray(base_position)
        if RT_base.shape[0] == 0:
            return PipelineResult(None, None, None, n_grasps, 0, 0,
                                  checking_time, 0.0, 0.0, "no_collision_free_grasp")

        t0 = self._now()
        q_sols, found = self.screen_ik(qc, RT_base, sdf_obs, base_position)
        ik_time = self._now() - t0
        RT_base = RT_base[found]
        q_solutions = q_sols[found].T
        if RT_base.shape[0] == 0:
            return PipelineResult(None, None, None, n_grasps, int(keep.sum()), 0,
                                  checking_time, ik_time, 0.0, "no_ik")

        # planning_time counts solve time only: the goal-set plan and any
        # re-solves, not the scoring replays
        t0 = self._now()
        cap = max(self.goal_capacity, RT_base.shape[0])
        plan, dQ, cost = self.planner.plan_goalset(
            qc, RT_base, sdf_all, sdf_obs, base_position, q_solutions,
            use_standoff=True, axis_standoff=self.axis_standoff,
            interpolate=self.interpolate, goal_capacity=cap,
        )
        cost = float(cost[0])
        planning_time = self._now() - t0

        rescued = False
        escalated = False
        if self.rescue:
            def gate_key(s):
                # reward first; then collision-free over reached (a plan
                # known to collide disturbs the scene, a clean miss is a
                # no-op); then reach; then the closest approach
                return (s["reward"], int(not s["collision"]), int(s["reached"]), -s["err_pos"])

            def score_batch(Q_all):
                return evaluate.score_plans_pergoal(
                    self.robot, self.link_ee, Q_all, RT_base, depth_pc_obstacle, base_position,
                    pos_tol=self.rescue_pos_tol, rot_tol_deg=self.rescue_rot_tol_deg,
                )

            def score_one(Q):
                return evaluate.score_plan(
                    self.robot, self.link_ee, Q, RT_base, depth_pc_obstacle, base_position,
                    pos_tol=self.rescue_pos_tol, rot_tol_deg=self.rescue_rot_tol_deg,
                )

            s0 = score_one(plan)
            best_key, best_score = gate_key(s0), s0
            if s0["reward"] == 0:
                t1 = self._now()
                Q_all, cost_all = self._plan_pergoal_field(
                    qc, RT_base, sdf_all, sdf_obs, base_position, q_solutions, cap
                )
                planning_time += self._now() - t1
                best_i = None
                for i, si in enumerate(score_batch(Q_all)):
                    ki = gate_key(si)
                    if ki > best_key:
                        best_key, best_score, best_i = ki, si, i
                if best_i is not None:
                    plan = Q_all[best_i]
                    cost = float(cost_all[best_i])
                    dQ = self.planner.dq_of(plan)
                    rescued = True

            # the last tier fires on any gate failure and picks its solver
            # by failure mode: a colliding best plan gets the exact-geometry
            # re-solve, a clean near-miss the deeper field re-solve; the
            # second tier runs only when the first did not clear the trial
            if self.escalate and best_score["reward"] == 0:
                first = "exact" if best_score["collision"] else "deep"
                for tier in (first, "deep" if first == "exact" else "exact"):
                    t1 = self._now()
                    if tier == "exact":
                        Q_e, cost_e = self._plan_pergoal_exact(
                            qc, RT_base, base_position, q_solutions, cap, depth, K, cam_pose, target_mask,
                        )
                    else:
                        Q_e, cost_e = self._plan_pergoal_deep(
                            qc, RT_base, sdf_all, sdf_obs, base_position, q_solutions, cap,
                        )
                    planning_time += self._now() - t1
                    best_e = None
                    for i, si in enumerate(score_batch(Q_e)):
                        ki = gate_key(si)
                        if ki > best_key:
                            best_key, best_score, best_e = ki, si, i
                    if best_e is not None:
                        plan = Q_e[best_e]
                        cost = float(cost_e[best_e])
                        dQ = self.planner.dq_of(plan)
                        rescued = True
                        escalated = True
                    if best_score["reward"] == 1:
                        break

            # safe decline: when every candidate still collides, hold the
            # best plan at its last collision-free step; gate_key ranks a
            # clean miss above a colliding reach, so the truncation is
            # adopted exactly then
            if best_score["collision"]:
                trunc = self._truncate_before_collision(plan, depth_pc_obstacle, base_position)
                if trunc is not None:
                    s_t = score_one(trunc)
                    if gate_key(s_t) > best_key:
                        best_key, best_score = gate_key(s_t), s_t
                        plan = trunc
                        dQ = self.planner.dq_of(plan)
                        rescued = True

        return PipelineResult(
            plan, dQ, cost, n_grasps, int(keep.sum()), int(found.sum()),
            checking_time, ik_time, planning_time, "ok", rescued=rescued, escalated=escalated,
        )

    def _truncate_before_collision(self, plan, depth_pc_obstacle, base_position):
        """(ndof, T) plan held at its last collision-free step, or None if
        the first step after the pinned start already collides. The step
        criterion is the replay scorer's: more than 5 points inside beyond
        those inside at step 0 (hard-coded 5, as in the JAX package)."""
        plan = np.asarray(plan)
        _, counts = evaluate.check_plan_collision(self.robot, plan, depth_pc_obstacle, base_position)
        bad = np.nonzero(counts > 5)[0]
        if len(bad) == 0 or bad[0] <= 1:
            return None
        k = int(bad[0])
        out = plan.copy()
        out[:, k:] = plan[:, k - 1 : k]
        return out

    def _pergoal(self, planner, qc, RT_base, base_position, q_solutions, cap, **sources):
        """planner.plan_pergoal_batch for this one object (C = 1, G = cap):
        goal b of the n = len(RT_base) real goals from its own IK solution
        (q_solutions (ndof, n)); slots past n re-solve goal n - 1 and are
        dropped. Goals are stored in float32, as the JAX package stores
        them. Returns host (Q (n, ndof, T), cost (n,))."""
        n = RT_base.shape[0]
        tf_goal = np.tile(np.eye(4, dtype=np.float32)[None], (cap, 1, 1))
        tf_goal[:n] = RT_base
        q_start = np.zeros((cap, self.robot.ndof))
        q_start[:n] = np.asarray(q_solutions).T
        Q, cost, _ = planner.plan_pergoal_batch(
            self._tensor(qc), self._tensor(tf_goal)[None],
            torch.full((1,), n, device=self.robot.device), self._tensor(q_start)[None],
            self._tensor(np.asarray(base_position)), True, self.axis_standoff, **sources,
        )
        return Q[0, :n].transpose(1, 2).cpu().numpy(), cost[0, :n].cpu().numpy()

    def _plan_pergoal_field(self, qc, RT_base, sdf_all, sdf_obs, base_position, q_solutions, cap, planner=None):
        """The per-goal batch on the cost fields (the rescue tier: the main
        planner's flavour)."""
        planner = planner or self.planner
        fields = planner.pack_stacked_fields(self._tensor(sdf_all)[None], self._tensor(sdf_obs)[None])
        return self._pergoal(planner, qc, RT_base, base_position, q_solutions, cap, fields=fields)

    def _plan_pergoal_deep(self, qc, RT_base, sdf_all, sdf_obs, base_position, q_solutions, cap):
        """Clean-near-miss escalation: the same field problem at the deeper
        escalate_iterations budget, no coarse phase, and a 4x goal weight
        (moving a goal-vs-obstacle equilibrium onto the goal; the gate only
        adopts a plan that scores strictly better)."""
        if self._planner_deep is None:
            self._planner_deep = GTOPlanner(
                self.robot, self.link_ee, self.link_gripper,
                standoff_distance=self.standoff_distance,
                standoff_offset=self.planner.standoff_offset,
                iterations=self.escalate_iterations,
                goal_weight=4.0 * self.planner.goal_weight,
                single_pass=self.planner.single_pass,
            )
        return self._plan_pergoal_field(
            qc, RT_base, sdf_all, sdf_obs, base_position, q_solutions, cap, planner=self._planner_deep
        )

    def _plan_pergoal_exact(
        self, qc, RT_base, base_position, q_solutions, cap, depth, K, cam_pose, target_mask,
    ):
        """The escalation tier's per-goal batch on exact signed distances
        to the observation's voxel-downsampled scene point sets (points
        mode, the replay criterion itself) at a boosted obstacle weight."""
        if self._planner_exact is None:
            self._planner_exact = GTOPlanner(
                self.robot, self.link_ee, self.link_gripper,
                standoff_distance=self.standoff_distance,
                standoff_offset=self.planner.standoff_offset,
                iterations=self.escalate_iterations,
                goal_weight=self.planner.goal_weight,
                obstacle_weight=self.escalate_obstacle_weight,
                obstacle_mode="points",
                sdf_epsilon=self.escalate_epsilon,
                single_pass=self.planner.single_pass,
            )
        depths, poses, masks = self._as_views(depth, cam_pose, target_mask)
        scene_obstacle, scene_target = scene_point_sets_from_depth(
            depths, K, poses, masks,
            capacity_obstacle=self.escalate_points_capacity,
            capacity_target=self.escalate_target_capacity,
            depth_threshold=self.depth_threshold,
            resolution=self.escalate_resolution,
        )
        scene = scene_sets_from_numpy(scene_obstacle, scene_target, self.robot.device, self.robot.dtype)
        return self._pergoal(self._planner_exact, qc, RT_base, base_position, q_solutions, cap, scene=scene)
