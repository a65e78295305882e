"""GTOPlanner: goal-set grasp trajectory optimization, field mode.

Port of grasptrajopt_tpu/planning/gto_planner.py for the trilinear-field
obstacle term with the single-pass LM: `setup_optimization` builds the
solver of one (goal capacity, standoff) signature and
`pack_stacked_fields` the per-problem stacked field table.

  - goal-set point-match cost with the active goal chosen per iteration
    (masked argmin, optional coherence bias toward a seeded goal); the
    standoff pose is matched at step T + standoff_offset;
  - obstacle cost sqrt(obstacle_weight) * trilinear field values at every
    body surface point: the scene field before the standoff step, the
    target-free obstacle field after it (one stacked (2S, 8) table per
    problem; `field_base` selects the problem's slab of the batch table);
  - velocity regularizer 0.01 * sum(dq^2) as the solver's smoothness term.

Batch-first: every solve takes B problems with per-problem params and
the shared stacked table; the plan phase runs no hand-written kernel.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from grasptrajopt_tpu_torch.ops.interp import field_lookup_packed_soa_grad
from grasptrajopt_tpu_torch.opt.trajectory import TrajectoryConfig, make_trajectory_solver
from grasptrajopt_tpu_torch.spatial import invt, standoff, transform_points


class PlannerSolvers(NamedTuple):
    """solve_batch_stacked(qc_opt (B, n), X0 (B, T-2, n), params_per,
    params_shared) -> (Q (B, T, n), cost (B,), aux): params_per holds
    q_param (B, n_param), tf_goal (B, G, 4, 4), goal_mask (B, G),
    base_position (B, 3), field_base (B,) and optionally goal_seed (B,);
    params_shared holds packed_fields (B*2S, 8)."""

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
                # one FK trace yields the surface points AND their joint
                # Jacobians; the field gradient is closed-form from the same
                # gathered corner rows as the value
                def pts_of(qq, q_param, base):
                    q_full = robot.assemble_q(qq, q_param)
                    xx, yy, zz = robot.surface_points_soa(
                        robot.fk_components(q_full), base, stride=stride
                    )
                    out = torch.stack([xx, yy, zz], dim=-1)  # (P, 3)
                    return out, out

                per_step = vmap(jacfwd(pts_of, has_aux=True), in_dims=(0, None, None))
                J_pts, pts = vmap(per_step)(Q, params["q_param"], params["base_position"])
                val, gx, gy, gz = field_lookup_packed_soa_grad(
                    shared["packed_fields"], pts[..., 0], pts[..., 1], pts[..., 2],
                    origin, g.shape, g.resolution, row_offset=field_rows(params),
                )
                grad = torch.stack([gx, gy, gz], dim=-1)  # (B, T, P, 3)
                J = sqrt_ow * torch.einsum("btpc,btpcn->btpn", grad, J_pts)
                return sqrt_ow * val, J

            return field_term_value, field_term_value_jac

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
        if self.coarse_iterations:
            coarse = (self.coarse_iterations, make_field_term(self.coarse_stride))
        solver = make_trajectory_solver(
            step_residual, cfg, pre_iteration=pre_iteration,
            traj_term=make_field_term(), coarse=coarse,
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
