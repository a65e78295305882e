"""GTOPlanner: goal-set grasp trajectory optimization.

Port of grasptrajopt_tpu/planning/gto_planner.py: `setup_optimization`
builds the solver of one (goal capacity, standoff) signature (shared or
per-problem stacked scene), `pack_stacked_fields` the stacked field table,
`rank_seed_scores` / `rank_pick` the warm-start ranking of IK candidates,
`plan` / `plan_goalset` the single-problem API, `plan_goalset_batch` the
batch API, and `plan_pergoal_batch` the per-goal tiers (one single-goal
problem per grasp).

  - goal-set point-match cost with the active goal chosen per iteration
    (masked argmin, optional coherence bias toward a seeded goal); the
    standoff pose is matched at step T + standoff_offset;
  - obstacle cost sqrt(obstacle_weight) * shaped SDF values at every body
    surface point, the scene before the standoff step and the target-free
    obstacle after it, from one of two sources (`obstacle_mode`), or none
    (`collision_avoidance=False`):
      'field':  trilinear lookups in one stacked (2S, 8) table per problem
                (`field_base` selects the problem's slab of the batch
                table), float32 or, with `field_dtype=torch.bfloat16`,
                bf16 rows (K4 upcasts them); `interp='nearest'` reads the
                unpacked fields at the floor-indexed cell instead, with a
                zero gradient;
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

from grasptrajopt_tpu_torch.convert import scene_sets_from_numpy
from grasptrajopt_tpu_torch.fields.depth_point_cloud import sdf_cost_shaping, sdf_cost_shaping_deriv
from grasptrajopt_tpu_torch.ops.interp import field_lookup_packed_soa_grad, points_to_offsets
from grasptrajopt_tpu_torch.ops.nn import signed_distance_with_dir
from grasptrajopt_tpu_torch.opt.trajectory import TrajectoryConfig, make_trajectory_solver
from grasptrajopt_tpu_torch.planning.utils import interpolate_waypoints
from grasptrajopt_tpu_torch.spatial import invt, standoff, transform_points


class PlannerSolvers(NamedTuple):
    """solve(qc_opt (B, n), X0 (B, T-2, n), params_per, params_shared)
    -> (Q (B, T, n), cost (B,), aux): params_per holds q_param
    (B, n_param), tf_goal (B, G, 4, 4), goal_mask (B, G), base_position
    (B, 3) and optionally goal_seed (B,).

    solve_batch_shared: one scene for the whole batch. params_shared holds
    packed_fields (2S, 8) in field mode (`field_table`: (2S,) with
    interp='nearest'; none without collision avoidance), and in points mode scene_points /
    scene_normals (1, K, 3) and target_points / target_normals (1, Kt, 3).
    solve_batch_stacked: per-problem scenes. params_per also holds
    field_base (B,), each problem's slab of packed_fields (B*2S, 8)
    (`pack_stacked_fields`); in points mode the sets are (C, K, 3) of C
    objects, the B problems in C equal contiguous groups.
    Both are one program: a shared table is a stacked one without
    field_base."""

    solve_batch_shared: callable
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
        lm_alphas=None,
        single_pass: bool = False,
        cyclic_reduction: bool = False,
        goal_weight: float = 1.0,
        obstacle_weight: float = 10.0,
        T: int = 50,
        Tmax: float = 10.0,
        coarse_iterations: int = 0,
        coarse_stride: int = 2,
        final_trust: bool = False,
        rank_t_stride: int = 1,
        rank_p_stride: int = 1,
        goal_coherence: float = 0.0,
        collision_avoidance: bool = True,
        interp: str = "trilinear",
        field_term: bool = True,
        field_dtype=None,
    ):
        """See the JAX package's GTOPlanner for each knob. field_term: the
        JAX package's whole-trajectory field term (True) or obstacle rows in
        the per-step residual (False); their residuals and Jacobians are
        equal in closed form, and here both are the whole-trajectory term,
        so that the lookup stays one K4 launch a pass for the whole batch
        (the per-step form would look up inside the torch.func transforms,
        where no kernel can run). lm_alphas: the
        two-pass iteration's trial step scales (None: (1.0,)); single_pass:
        one residual/jac pass per LM iteration (coarse_iterations and
        final_trust need it; final_trust is dropped without it);
        cyclic_reduction: the KKT step by cyclic reduction (long horizons);
        rank_{t,p}_stride: the warm-start ranking scores every rank_t-th
        step (anchored at the last) and every rank_p-th surface point
        (field mode only)."""
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
        self.lm_alphas = None if lm_alphas is None else tuple(float(a) for a in lm_alphas)
        self.single_pass = bool(single_pass)
        self.cyclic_reduction = bool(cyclic_reduction)
        self.rank_t_stride = int(rank_t_stride)
        self.rank_p_stride = int(rank_p_stride)
        self.goal_coherence = float(goal_coherence)
        if interp not in ("trilinear", "nearest"):
            raise ValueError(f"unknown interp mode '{interp}'")
        self.collision_avoidance = bool(collision_avoidance)
        self.interp = interp
        self.field_term = bool(field_term)
        self.field_dtype = field_dtype
        self.gripper_points = robot.gripper_points(link_gripper)
        self._solvers: Dict[tuple, PlannerSolvers] = {}
        self._last_rank_pick = None  # seed / goal index of the last ranked warm start

    def setup_optimization(
        self, goal_size: int = 1, use_standoff: bool = False, axis_standoff: str = "x"
    ) -> PlannerSolvers:
        """Build (and cache) the solver for one goal capacity on the robot's
        current grid (a driver that gives each object its own grid gets a
        solver for each)."""
        g = self.robot.grid
        key = (goal_size, use_standoff, axis_standoff, g)
        if key in self._solvers:
            return self._solvers[key]

        robot = self.robot
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
            """Row offset per (problem, step): (T, 1) for a shared table,
            (B, T, 1) for a stacked one."""
            if "field_base" not in params:
                return phase_row
            return phase_row + params["field_base"][:, None, None]

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
            point stride (stride > 1: the coarse phase's subsampled term).
            Each is ONE K4 lookup for the whole batch, outside the
            torch.func transforms (the origin as host floats)."""

            def field_term_value(Q, step_aux, params, shared):
                q_param = params["q_param"][:, None, :]
                Qf = robot.assemble_q(Q, q_param)
                x, y, z = robot.surface_points_soa(
                    robot.fk_components(Qf), params["base_position"][:, None, :], stride=stride
                )  # (B, T, P) each
                val, _, _, _ = field_lookup_packed_soa_grad(
                    shared["packed_fields"], x, y, z, g.origin, g.shape, g.resolution,
                    row_offset=field_rows(params),
                )
                return sqrt_ow * val

            def field_term_value_jac(Q, step_aux, params, shared):
                # the field gradient is closed-form from the same gathered
                # corner rows as the value
                J_pts, pts = traced_points(Q, params, stride)
                pts = pts.contiguous()  # x / y / z views, 3 elements apart
                val, gx, gy, gz = field_lookup_packed_soa_grad(
                    shared["packed_fields"], pts[..., 0], pts[..., 1], pts[..., 2],
                    g.origin, g.shape, g.resolution, row_offset=field_rows(params),
                )
                grad = torch.stack([gx, gy, gz], dim=-1)  # (B, T, P, 3)
                J = sqrt_ow * torch.einsum("btpc,btpcn->btpn", grad, J_pts)
                return sqrt_ow * val, J

            return field_term_value, field_term_value_jac

        def nearest_term_value(Q, step_aux, params, shared):
            """interp='nearest': the unpacked fields (flat, the scene's
            then the obstacle's, stacked like the packed table) at each
            point's floor-indexed cell."""
            Qf = robot.assemble_q(Q, params["q_param"][:, None, :])
            x, y, z = robot.surface_points_soa(robot.fk_components(Qf), params["base_position"][:, None, :])
            offs = points_to_offsets(
                torch.stack([x, y, z], dim=-1), g.origin_tensor(x.dtype, x.device), g.shape, g.resolution
            )
            return sqrt_ow * shared["packed_fields"][offs + field_rows(params)].to(x.dtype)

        def nearest_term_value_jac(Q, step_aux, params, shared):
            r = nearest_term_value(Q, step_aux, params, shared)
            return r, torch.zeros(r.shape + (Q.shape[-1],), dtype=r.dtype, device=r.device)

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

        cfg_kwargs = {} if self.lm_alphas is None else {"alphas": self.lm_alphas}
        cfg = TrajectoryConfig(
            T=T,
            n_fixed=2,
            smooth_weight=0.01 / self.dt**2,
            iterations=self.iterations,
            single_pass=self.single_pass,
            final_trust=self.final_trust and self.single_pass,
            cyclic_reduction=self.cyclic_reduction,
            **cfg_kwargs,
        )
        coarse = None
        trilinear_term = (
            self.collision_avoidance and self.obstacle_mode == "field" and self.interp == "trilinear"
        )
        if self.coarse_iterations and not (trilinear_term and self.field_term and self.single_pass):
            raise NotImplementedError(
                "coarse_iterations requires single_pass=True and the trilinear field obstacle term"
            )
        if not self.collision_avoidance:
            traj_term = None
        elif self.obstacle_mode == "points":
            traj_term = (obstacle_term_value, obstacle_term_value_jac)
        elif trilinear_term:
            traj_term = make_field_term()
            if self.coarse_iterations:
                coarse = (self.coarse_iterations, make_field_term(self.coarse_stride))
        else:
            traj_term = (nearest_term_value, nearest_term_value_jac)
        solver = make_trajectory_solver(
            step_residual, cfg, pre_iteration=pre_iteration, traj_term=traj_term, coarse=coarse,
        )
        lo = torch.as_tensor(robot.lower_optimized_joint_limits, dtype=dtype, device=dev)
        hi = torch.as_tensor(robot.upper_optimized_joint_limits, dtype=dtype, device=dev)

        def solve(qc_opt, X0, params_per, params_shared):
            return solver(qc_opt, X0, lo, hi, params_per, params_shared)

        self._solvers[key] = PlannerSolvers(solve, solve)
        return self._solvers[key]

    def field_table(self, sdf_cost_all, sdf_cost_obstacle):
        """The field table the obstacle term reads, from (..., S) field
        pairs: the corner rows of both fields (..., 2S, 8) in field_dtype,
        or with interp='nearest' the fields themselves (..., 2S)."""
        if self.interp == "nearest":
            return torch.cat([sdf_cost_all, sdf_cost_obstacle], dim=-1)
        g = self.robot.grid
        return torch.cat(
            [g.pack(sdf_cost_all, self.field_dtype), g.pack(sdf_cost_obstacle, self.field_dtype)], dim=-2
        )

    def pack_stacked_fields(self, sdf_cost_all_b, sdf_cost_obstacle_b):
        """Pack B per-problem field pairs (B, S) into ONE flat (B*2S, 8)
        corner table (the flat (B*2S,) fields with interp='nearest') + the
        (B,) per-problem base row offsets."""
        g = self.robot.grid
        tables = self.field_table(sdf_cost_all_b, sdf_cost_obstacle_b)
        B = tables.shape[0]
        base = torch.arange(B, device=tables.device) * (2 * g.size)
        return tables.reshape((B * 2 * g.size,) + tables.shape[2:]), base

    def _seed_trajectories(self, qc, q_solutions):
        """Seed trajectories (..., T, ndof) from qc (ndof,) to each IK
        solution q_solutions (..., ndof): the smoothstep interpolation to T
        samples, param joints pinned at qc. (Callers drop the first two
        samples for X0, so the seed differs from the slice's warm start,
        which interpolates to T - 2 samples.)"""
        data = interpolate_waypoints(qc, q_solutions, self.T)
        pin = torch.zeros(qc.shape[-1], dtype=torch.bool, device=qc.device)
        pin.index_fill_(0, self.robot._par_idx, True)  # a device index: no host copy
        return torch.where(pin, qc, data)

    # -- warm starts ------------------------------------------------------------

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.robot.dtype, device=self.robot.device)

    def dq_of(self, Q):
        """Finite-difference joint velocities (ndof, T-1) of an (ndof, T)
        host plan; param joints stay zero."""
        dQ = np.zeros((self.robot.ndof, Q.shape[1] - 1))
        opt_idx = self.robot.optimized_joint_indexes
        dQ[opt_idx, :] = (Q[opt_idx, 1:] - Q[opt_idx, :-1]) / self.dt
        return dQ

    def rank_seed_scores(self, seeds, sdf_cost_obstacle, base_position, scene_obstacle=None):
        """(costs (..., k), dists (..., k)) of seed trajectories
        (..., k, T, ndof): the summed obstacle cost of each replayed seed
        (floor-indexed field values, or in points mode the shaped signed
        distance to the obstacle set `scene_obstacle`, one K2 launch) and
        its start-to-end travel as the tie break. Field mode takes one flat
        field (S,), or one per leading batch entry (..., S).

        Field mode with rank strides scores every rank_t-th step, anchored
        at the last step (the grasp pose), and every rank_p-th surface
        point."""
        robot = self.robot
        seeds = self._tensor(seeds)
        base = self._tensor(base_position)
        if self.obstacle_mode != "points" and (self.rank_t_stride > 1 or self.rank_p_stride > 1):
            steps = torch.arange(self.T - 1, -1, -self.rank_t_stride, device=seeds.device).flip(0)
            x, y, z = robot.surface_points_soa(
                robot.fk_components(seeds[..., steps, :]), base, stride=self.rank_p_stride
            )
            pts = torch.stack([x, y, z], dim=-1)
        else:
            pts = robot.fk_surface_points(seeds, base)
        if self.obstacle_mode == "points":
            sd, _ = signed_distance_with_dir(
                pts, self._tensor(scene_obstacle.points), self._tensor(scene_obstacle.normals)
            )
            vals = sdf_cost_shaping(sd, epsilon=self.sdf_epsilon)
        else:
            field = self._tensor(sdf_cost_obstacle)
            if field.dim() == 1:
                vals = robot.grid.lookup_nearest(field, pts)
            else:  # one field per leading batch entry: gather from the flat stack
                lead = field.shape[:-1]
                first = torch.arange(field[..., 0].numel(), device=field.device).reshape(lead) * field.shape[-1]
                offs = robot.grid.offsets(pts) + first.reshape(lead + (1,) * (pts.dim() - 1 - len(lead)))
                vals = field.reshape(-1)[offs]
        costs = torch.sum(vals, dim=(-2, -1))
        dists = torch.linalg.vector_norm(seeds[..., 0, :] - seeds[..., -1, :], dim=-1)
        return costs, dists

    @staticmethod
    def rank_pick(costs, dists):
        """Index (...,) of the lexicographic (cost, dist) winner over the
        last axis: among min-cost seeds, the one with the smallest travel
        (the first on a tie)."""
        tied = costs == torch.amin(costs, dim=-1, keepdim=True)
        return torch.argmin(torch.where(tied, dists, torch.full_like(dists, float("inf"))), dim=-1)

    def _rank_warm_starts(self, qc, q_solutions, sdf_cost_obstacle, base_position, scene_obstacle=None):
        """Seed trajectories from qc (ndof,) to each IK candidate
        q_solutions (k, ndof), ranked by (plan cost, travel). Returns (best
        seed (T, ndof), costs (k,), dists (k,)) and records the winner's
        index in `_last_rank_pick`."""
        seeds = self._seed_trajectories(qc, q_solutions)
        costs, dists = self.rank_seed_scores(seeds, sdf_cost_obstacle, base_position, scene_obstacle)
        best = self.rank_pick(costs, dists)
        self._last_rank_pick = best
        # index_select: indexing by a 0-dim tensor would read it on the host
        return seeds.index_select(0, best.reshape(1))[0], costs, dists

    # -- public API ---------------------------------------------------------------

    def plan(self, qc, RT, sdf_cost_obstacle, base_position, q_solution=None,
             use_standoff: bool = True, axis_standoff: str = "x"):
        """Single-goal plan. As in the reference, only the final phase sees
        the obstacle field: the scene field is zero. Returns host numpy
        (Q (ndof, T), dQ (ndof, T-1), cost (1,))."""
        RTs = np.asarray(RT)[None]
        q_solutions = None if q_solution is None else np.asarray(q_solution).reshape(-1, 1)
        zeros_all = np.zeros(np.shape(sdf_cost_obstacle))
        return self.plan_goalset(
            qc, RTs, zeros_all, sdf_cost_obstacle, base_position, q_solutions=q_solutions,
            use_standoff=use_standoff, axis_standoff=axis_standoff,
        )

    def plan_goalset(
        self, qc, RTs, sdf_cost_all, sdf_cost_obstacle, base_position, q_solutions=None,
        use_standoff: bool = True, axis_standoff: str = "x", interpolate: bool = True,
        goal_capacity=None, scene_obstacle=None, scene_target=None,
    ):
        """Goal-set plan of one problem, in the JAX package's host layout:
        qc (ndof,); RTs (n, 4, 4) candidate grasps (of link_ee, base
        frame); flat (S,) cost fields on the robot's grid (field mode) or
        ScenePointSets `scene_obstacle` / `scene_target` (points mode);
        q_solutions optional (ndof, k) IK candidates, ranked into the warm
        start (interpolate=False: hold qc, then the winner's end pose from
        the standoff step on). `goal_capacity` pads the goal set. Goals are
        stored in float32, as the JAX package stores them.
        Returns host numpy (Q (ndof, T), dQ (ndof, T-1), cost (1,))."""
        robot = self.robot
        qc = self._tensor(qc).reshape(-1)
        RTs = np.asarray(RTs)
        n = RTs.shape[0]
        cap = goal_capacity or n
        if n > cap:
            raise ValueError(f"{n} goals exceed the goal capacity {cap}")
        tf_goal = np.tile(np.eye(4, dtype=np.float32)[None], (cap, 1, 1))
        tf_goal[:n] = RTs
        goal_mask = np.zeros(cap, dtype=bool)
        goal_mask[:n] = True

        if q_solutions is None:
            Q0_full = qc.expand(self.T, -1)
        else:
            best_seed, _, _ = self._rank_warm_starts(
                qc, self._tensor(q_solutions).T, sdf_cost_obstacle, base_position, scene_obstacle
            )
            if interpolate:
                Q0_full = best_seed
            else:
                hold = torch.arange(self.T, device=qc.device)[:, None] >= self.T + self.standoff_offset
                Q0_full = torch.where(hold, best_seed[-1], qc)
        q_param = robot.extract_parameter_dimensions(qc)
        params = {
            "q_param": q_param[None],
            "tf_goal": self._tensor(tf_goal)[None],
            "goal_mask": torch.as_tensor(goal_mask, device=qc.device)[None],
            "base_position": self._tensor(base_position)[None],
        }
        if self.goal_coherence > 0.0 and q_solutions is not None and np.shape(q_solutions)[1] == n:
            # goal-aligned candidates: the ranked seed's index is its goal
            params["goal_seed"] = self._last_rank_pick.reshape(1)
        if self.obstacle_mode == "points":
            if scene_obstacle is None or scene_target is None:
                raise ValueError("obstacle_mode='points' needs scene_obstacle and scene_target ScenePointSets")
            shared = scene_sets_from_numpy(scene_obstacle, scene_target, robot.device, robot.dtype)
        else:
            shared = {"packed_fields": self.field_table(self._tensor(sdf_cost_all), self._tensor(sdf_cost_obstacle))}
        solvers = self.setup_optimization(cap, use_standoff, axis_standoff)
        X0 = robot.extract_optimized_dimensions(Q0_full[2:])
        Q_opt, cost, _ = solvers.solve_batch_shared(
            robot.extract_optimized_dimensions(qc)[None], X0[None], params, shared
        )
        Q = robot.assemble_q(Q_opt[0], q_param).T.cpu().numpy()
        return Q, self.dq_of(Q), cost.cpu().numpy().reshape(1)

    def plan_goalset_batch(
        self, qc, tf_goal, goal_mask, sdf_cost_all, sdf_cost_obstacle, base_position, Q0_full,
        use_standoff: bool = True, axis_standoff: str = "x",
    ):
        """B independent goal-set problems in one solve, each with its own
        fields, on the stacked table: qc (B, ndof); tf_goal (B, cap, 4, 4);
        goal_mask (B, cap); fields (B, S); base_position (B, 3); Q0_full
        (B, T, ndof) warm starts. Returns tensors (Q (B, T, ndof), cost
        (B,))."""
        robot = self.robot
        qc = self._tensor(qc)
        tables, base = self.pack_stacked_fields(self._tensor(sdf_cost_all), self._tensor(sdf_cost_obstacle))
        q_param = robot.extract_parameter_dimensions(qc)
        params = {
            "q_param": q_param,
            "tf_goal": self._tensor(tf_goal),
            "goal_mask": torch.as_tensor(goal_mask, device=qc.device),
            "base_position": self._tensor(base_position),
            "field_base": base,
        }
        solvers = self.setup_optimization(tf_goal.shape[1], use_standoff, axis_standoff)
        Q_opt, cost, _ = solvers.solve_batch_stacked(
            robot.extract_optimized_dimensions(qc),
            robot.extract_optimized_dimensions(self._tensor(Q0_full)[:, 2:]),
            params, {"packed_fields": tables},
        )
        return robot.assemble_q(Q_opt, q_param[:, None, :]), cost

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
