"""GTOPlanner: goal-set grasp trajectory optimization.

Port of grasptrajopt_tpu/planning/gto_planner.py with the single-pass LM:
`setup_optimization` builds the solver of one (goal capacity, standoff)
signature, `pack_stacked_fields` the per-problem stacked field table,
`plan_pergoal_batch` the per-goal tiers (one single-goal problem per
grasp).

  - goal-set point-match cost with the active goal chosen per iteration
    (masked argmin, optional coherence bias toward a seeded goal); the
    standoff pose is matched at step T + standoff_offset;
  - obstacle cost sqrt(obstacle_weight) * shaped SDF values at every body
    surface point, the scene before the standoff step and the target-free
    obstacle after it, from one of two sources (`obstacle_mode`):
      'field':  trilinear lookups in one stacked (2S, 8) table per problem
                (`field_base` selects the problem's slab of the batch
                table);
      'points': the exact signed distance to voxel-downsampled scene
                point sets with normals (kernel K2; the target set counts
                where it is nearer during the standoff phase);
  - velocity regularizer 0.01 * sum(dq^2) as the solver's smoothness term.

Batch-first: every solve takes B problems with per-problem params and
shared params common to the batch (the stacked table, or the scene point
sets of C objects with the problems grouped contiguously by object, so
each points-mode pass is one K2 launch per point set).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from grasptrajopt_tpu_torch.fields.depth_point_cloud import sdf_cost_shaping, sdf_cost_shaping_deriv
from grasptrajopt_tpu_torch.ops.interp import field_lookup_packed_soa_grad
from grasptrajopt_tpu_torch.ops.nn import signed_distance_with_dir
from grasptrajopt_tpu_torch.opt.trajectory import TrajectoryConfig, make_trajectory_solver
from grasptrajopt_tpu_torch.planning.utils import interpolate_waypoints
from grasptrajopt_tpu_torch.spatial import invt, standoff, transform_points


class PlannerSolvers(NamedTuple):
    """solve_batch_stacked(qc_opt (B, n), X0 (B, T-2, n), params_per,
    params_shared) -> (Q (B, T, n), cost (B,), aux): params_per holds
    q_param (B, n_param), tf_goal (B, G, 4, 4), goal_mask (B, G),
    base_position (B, 3), field_base (B,) and optionally goal_seed (B,);
    params_shared holds packed_fields (B*2S, 8) in field mode, and in
    points mode scene_points / scene_normals (C, K, 3) and target_points /
    target_normals (C, Kt, 3) of C objects, B a multiple of C."""

    solve_batch_stacked: callable


class GTOPlanner:
    def __init__(
        self,
        robot,
        link_ee: str,
        link_gripper: str,
        standoff_distance: float = -0.1,
        standoff_offset: int = -10,
        iterations: int = 50,
        obstacle_mode: str = "field",
        sdf_epsilon: float = 0.02,
        goal_weight: float = 1.0,
        obstacle_weight: float = 10.0,
        T: int = 50,
        Tmax: float = 10.0,
        coarse_iterations: int = 0,
        coarse_stride: int = 2,
        final_trust: bool = False,
        goal_coherence: float = 0.0,
    ):
        self.robot = robot
        self.link_ee = link_ee
        self.link_gripper = link_gripper
        self.standoff_distance = standoff_distance
        self.standoff_offset = standoff_offset
        self.iterations = iterations
        if obstacle_mode not in ("field", "points"):
            raise ValueError(f"obstacle_mode must be 'field' or 'points', got {obstacle_mode!r}")
        self.obstacle_mode = obstacle_mode
        self.sdf_epsilon = sdf_epsilon
        self.goal_weight = float(goal_weight)
        self.obstacle_weight = float(obstacle_weight)
        self.T = int(T)
        self.Tmax = float(Tmax)
        self.dt = self.Tmax / (self.T - 1)
        self.coarse_iterations = int(coarse_iterations)
        self.coarse_stride = int(coarse_stride)
        self.final_trust = bool(final_trust)
        self.goal_coherence = float(goal_coherence)
        self.gripper_points = robot.gripper_points(link_gripper)
        self._solvers: Dict[tuple, PlannerSolvers] = {}

    def setup_optimization(
        self, goal_size: int = 1, use_standoff: bool = False, axis_standoff: str = "x"
    ) -> PlannerSolvers:
        """Build (and cache) the solver for one goal capacity."""
        key = (goal_size, use_standoff, axis_standoff)
        if key in self._solvers:
            return self._solvers[key]

        robot = self.robot
        g = robot.grid
        dtype, dev = robot.dtype, robot.device
        T = self.T
        t_standoff = T + self.standoff_offset
        ee_frame = robot.frame_of(self.link_ee)
        grip_frame = robot.frame_of(self.link_gripper)
        gpts = self.gripper_points
        # the JAX package builds this pose in float32 before casting it to
        # the working dtype; round the same way so float64 runs agree
        pose_standoff = standoff(
            float(np.float32(self.standoff_distance)), axis_standoff, dtype, dev
        )
        sqrt_ow = math.sqrt(self.obstacle_weight)
        sqrt_gw = math.sqrt(self.goal_weight)
        origin = g.origin_tensor(dtype, dev)
        # per-step field slab: scene field before the standoff step, the
        # target-free obstacle field from it on
        phase_row = (torch.arange(T, device=dev) >= t_standoff).long()[:, None] * g.size

        def goal_diffs_from(T_ee, T_grip, tf_goal):
            """Point differences (cur - goal-placed) for final and standoff;
            T_ee / T_grip (..., 4, 4) broadcast against tf_goal."""
            gripper_tf = invt(T_ee) @ T_grip
            pts_cur = transform_points(T_grip, gpts)
            d_final = pts_cur - transform_points(tf_goal @ gripper_tf, gpts)
            if use_standoff:
                d_stand = pts_cur - transform_points(tf_goal @ pose_standoff @ gripper_tf, gpts)
            else:
                d_stand = torch.zeros_like(d_final)
            return d_final, d_stand

        def field_rows(params):
            return phase_row + params["field_base"][:, None, None]  # (B, T, 1)

        def traced_points(Q, params, stride: int = 1):
            """(J_pts (B, T, P, 3, n), pts (B, T, P, 3)): world surface points
            and their joint Jacobians from ONE FK trace per step."""

            def pts_of(qq, q_param, base):
                q_full = robot.assemble_q(qq, q_param)
                xx, yy, zz = robot.surface_points_soa(robot.fk_components(q_full), base, stride=stride)
                out = torch.stack([xx, yy, zz], dim=-1)  # (P, 3)
                return out, out

            per_step = vmap(jacfwd(pts_of, has_aux=True), in_dims=(0, None, None))
            return vmap(per_step)(Q, params["q_param"], params["base_position"])

        def make_field_term(stride: int = 1):
            """(value, value_jac) whole-trajectory field term at a surface
            point stride (stride > 1: the coarse phase's subsampled term)."""

            def field_term_value(Q, step_aux, params, shared):
                q_param = params["q_param"][:, None, :]
                Qf = robot.assemble_q(Q, q_param)
                x, y, z = robot.surface_points_soa(
                    robot.fk_components(Qf), params["base_position"][:, None, :], stride=stride
                )  # (B, T, P) each
                val, _, _, _ = field_lookup_packed_soa_grad(
                    shared["packed_fields"], x, y, z, origin, g.shape, g.resolution,
                    row_offset=field_rows(params),
                )
                return sqrt_ow * val

            def field_term_value_jac(Q, step_aux, params, shared):
                # the field gradient is closed-form from the same gathered
                # corner rows as the value
                J_pts, pts = traced_points(Q, params, stride)
                val, gx, gy, gz = field_lookup_packed_soa_grad(
                    shared["packed_fields"], pts[..., 0], pts[..., 1], pts[..., 2],
                    origin, g.shape, g.resolution, row_offset=field_rows(params),
                )
                grad = torch.stack([gx, gy, gz], dim=-1)  # (B, T, P, 3)
                J = sqrt_ow * torch.einsum("btpc,btpcn->btpn", grad, J_pts)
                return sqrt_ow * val, J

            return field_term_value, field_term_value_jac

        # points mode: during the standoff phase the target's surface is an
        # obstacle too (the nearer of the two sets); the final approach
        # ignores the target
        phase_col = (torch.arange(T, device=dev) < t_standoff)[:, None]  # (T, 1)

        def obstacle_sd_dir(pts, shared):
            """Signed distances (B, T, P) and their spatial gradients of the
            body points pts (B, T, P, 3): one K2 launch per point set for the
            whole batch, the problems of object c being the c-th of C equal
            contiguous groups."""
            C = shared["scene_points"].shape[0]
            q = pts.reshape(C, -1, 3)
            sd_o, dir_o = signed_distance_with_dir(q, shared["scene_points"], shared["scene_normals"])
            sd_t, dir_t = signed_distance_with_dir(q, shared["target_points"], shared["target_normals"])
            sd_o, sd_t = sd_o.reshape(pts.shape[:-1]), sd_t.reshape(pts.shape[:-1])
            take_t = phase_col & (torch.abs(sd_t) < torch.abs(sd_o))
            sd = torch.where(take_t, sd_t, sd_o)
            dirs = torch.where(take_t[..., None], dir_t.reshape(pts.shape), dir_o.reshape(pts.shape))
            return sd, dirs

        def obstacle_term_value(Q, step_aux, params, shared):
            Qf = robot.assemble_q(Q, params["q_param"][:, None, :])
            x, y, z = robot.surface_points_soa(robot.fk_components(Qf), params["base_position"][:, None, :])
            sd, _ = obstacle_sd_dir(torch.stack([x, y, z], dim=-1), shared)
            return sqrt_ow * sdf_cost_shaping(sd, epsilon=self.sdf_epsilon)

        def obstacle_term_value_jac(Q, step_aux, params, shared):
            J_pts, pts = traced_points(Q, params)
            sd, dirs = obstacle_sd_dir(pts, shared)
            r = sqrt_ow * sdf_cost_shaping(sd, epsilon=self.sdf_epsilon)
            drdsd = sqrt_ow * sdf_cost_shaping_deriv(sd, epsilon=self.sdf_epsilon)
            J = torch.einsum("btp,btpc,btpcn->btpn", drdsd, dirs, J_pts)
            return r, J

        def step_residual(q_opt, t, goal_idx, p):
            """Goal rows of ONE step of ONE problem (the obstacle rows are
            the whole-trajectory field term)."""
            comps = robot.fk_components(robot.assemble_q(q_opt, p["q_param"]))
            d_final, d_stand = goal_diffs_from(
                robot.frame_matrix(comps, ee_frame),
                robot.frame_matrix(comps, grip_frame),
                p["tf_goal"][goal_idx],
            )
            is_final = (t == T - 1).to(dtype)
            is_stand = (t == t_standoff).to(dtype) if use_standoff else torch.zeros((), dtype=dtype, device=dev)
            return (sqrt_gw * (is_final * d_final + is_stand * d_stand)).reshape(-1)

        def pre_iteration(Q, params, shared):
            """Active goal per problem: masked argmin over the goal set of
            the point-match cost at the current trajectory."""
            q_param = params["q_param"]
            frames_f = robot.fk_all(robot.assemble_q(Q[:, T - 1], q_param))
            d_final, _ = goal_diffs_from(
                frames_f[:, None, ee_frame], frames_f[:, None, grip_frame], params["tf_goal"]
            )
            costs = torch.sum(d_final * d_final, dim=(-2, -1))  # (B, G)
            if use_standoff:
                frames_s = robot.fk_all(robot.assemble_q(Q[:, t_standoff], q_param))
                _, d_stand = goal_diffs_from(
                    frames_s[:, None, ee_frame], frames_s[:, None, grip_frame], params["tf_goal"]
                )
                costs = costs + torch.sum(d_stand * d_stand, dim=(-2, -1))
            costs = torch.where(params["goal_mask"], costs, torch.full_like(costs, float("inf")))
            if self.goal_coherence > 0.0 and "goal_seed" in params:
                idx = torch.arange(costs.shape[1], device=dev)
                costs = torch.where(
                    idx[None, :] == params["goal_seed"][:, None],
                    costs / self.goal_coherence,
                    costs,
                )
            return torch.argmin(costs, dim=1)

        cfg = TrajectoryConfig(
            T=T,
            n_fixed=2,
            smooth_weight=0.01 / self.dt**2,
            iterations=self.iterations,
            final_trust=self.final_trust,
        )
        coarse = None
        if self.obstacle_mode == "points":
            if self.coarse_iterations:
                raise NotImplementedError("coarse_iterations requires the field obstacle term")
            traj_term = (obstacle_term_value, obstacle_term_value_jac)
        else:
            traj_term = make_field_term()
            if self.coarse_iterations:
                coarse = (self.coarse_iterations, make_field_term(self.coarse_stride))
        solver = make_trajectory_solver(
            step_residual, cfg, pre_iteration=pre_iteration, traj_term=traj_term, coarse=coarse,
        )
        lo = torch.as_tensor(robot.lower_optimized_joint_limits, dtype=dtype, device=dev)
        hi = torch.as_tensor(robot.upper_optimized_joint_limits, dtype=dtype, device=dev)

        def solve_batch_stacked(qc_opt, X0, params_per, params_shared):
            return solver(qc_opt, X0, lo, hi, params_per, params_shared)

        self._solvers[key] = PlannerSolvers(solve_batch_stacked)
        return self._solvers[key]

    def pack_stacked_fields(self, sdf_cost_all_b, sdf_cost_obstacle_b):
        """Pack B per-problem field pairs (B, S) into ONE flat (B*2S, 8)
        corner table + the (B,) per-problem base row offsets."""
        g = self.robot.grid
        tables = torch.cat([g.pack(sdf_cost_all_b), g.pack(sdf_cost_obstacle_b)], dim=1)
        B = tables.shape[0]
        base = torch.arange(B, device=tables.device) * (2 * g.size)
        return tables.reshape(B * 2 * g.size, 8), base

    def _seed_trajectories(self, qc, q_solutions):
        """Seed trajectories (..., T, ndof) from qc (ndof,) to each IK
        solution q_solutions (..., ndof): the smoothstep interpolation to T
        samples, param joints pinned at qc. (Callers drop the first two
        samples for X0, so the seed differs from the slice's warm start,
        which interpolates to T - 2 samples.)"""
        data = interpolate_waypoints(qc, q_solutions, self.T)
        pin = torch.zeros(qc.shape[-1], dtype=torch.bool, device=qc.device)
        pin[self.robot.parameter_joint_indexes] = True
        return torch.where(pin, qc, data)

    def plan_pergoal_batch(
        self, qc, tf_goal, n_goals, q_solutions, base_position,
        use_standoff: bool = True, axis_standoff: str = "x", scene=None, fields=None,
    ):
        """One independent single-goal solve per goal slot of each of C
        objects, in one batch of B = C * G problems grouped by object.

        Problem (c, b) targets goal min(b, n_goals[c] - 1) of object c (a
        one-hot goal mask on the goal-set solver) and starts from that
        goal's own IK solution, so a bad compromise of the goal-set solve
        cannot drag every grasp into the same local minimum. Slots past
        n_goals[c] re-solve the last real goal.

        qc (ndof,); tf_goal (C, G, 4, 4) base frame, each object's real
        goals first; n_goals (C,) >= 1; q_solutions (C, G, ndof), one IK
        solution per goal slot; base_position (3,) or (C, 3).
        Points mode: `scene` = the shared point-set params (see
        PlannerSolvers; convert.scene_sets_from_numpy). Field mode:
        `fields` = (tables (C*2S, 8), base (C,)) from pack_stacked_fields.
        Returns Q (C, G, T, ndof), cost (C, G) and the solver's aux.
        """
        robot = self.robot
        C, G = tf_goal.shape[:2]
        B = C * G
        dev = tf_goal.device
        slots = torch.arange(G, device=dev)
        bidx = torch.minimum(slots[None, :], n_goals.to(dev)[:, None] - 1)  # (C, G)
        goal_mask = (bidx[..., None] == slots).reshape(B, G)
        q_start = torch.gather(q_solutions, 1, bidx[..., None].expand(C, G, q_solutions.shape[-1]))
        seeds = self._seed_trajectories(qc, q_start)  # (C, G, T, ndof)
        X0 = robot.extract_optimized_dimensions(seeds[..., 2:, :]).reshape(B, self.T - 2, -1)
        q_param = robot.extract_parameter_dimensions(qc)
        params = {
            "q_param": q_param.expand(B, -1),
            "tf_goal": tf_goal[:, None].expand(C, G, G, 4, 4).reshape(B, G, 4, 4),
            "goal_mask": goal_mask,
            "base_position": base_position.expand(C, 3).repeat_interleave(G, dim=0),
        }
        if self.obstacle_mode == "points":
            shared = scene
        else:
            tables, base = fields
            params["field_base"] = base.repeat_interleave(G)
            shared = {"packed_fields": tables}
        solvers = self.setup_optimization(G, use_standoff, axis_standoff)
        qc_opt = robot.extract_optimized_dimensions(qc).expand(B, -1)
        Q_opt, cost, aux = solvers.solve_batch_stacked(qc_opt, X0, params, shared)
        Q_full = robot.assemble_q(Q_opt, q_param)
        return Q_full.reshape(C, G, self.T, -1), cost.reshape(C, G), aux
