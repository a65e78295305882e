"""IKSolver: point-matching inverse kinematics with obstacle avoidance.

Port of grasptrajopt_tpu/planning/ik_solver.py. The cost is the summed
squared distance between the gripper link's surface points at fk(q) and
the same points placed at the goal pose (`cost='point'`), or position plus
a quaternion-alignment (`'quaternion'`: 1 - <q, q*>^2) or RPY (`'rpy'`)
term; with `collision_avoidance`, plus 10x the summed obstacle cost of all
body surface points (a linear value term). One projected-LM solve covers
the whole grasp batch; with multistart, every goal's seed and its random
restarts are one LM batch too.

The obstacle term is batch-level (opt/lm.py `value_term`): with
`interp='trilinear'` the obstacle field is packed once per solve into one
corner table shared by the batch, and every evaluation (the starting cost,
then per LM iteration the linearisation and the trial candidates) is one
K4 launch for the whole batch, its gradient K4's closed-form spatial
gradient contracted with the body points' Jacobians from one batched FK
trace. `interp='nearest'` is a plain gather with a zero gradient, and the
reported `col_cost` (the unweighted nearest-cell sum at the solution) is a
plain gather too, as in the JAX package, where neither is a kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.func import jacfwd, vmap

from grasptrajopt_tpu_torch.ops.interp import field_lookup_packed_soa_grad
from grasptrajopt_tpu_torch.opt.lm import LMConfig, make_box_lm_solver
from grasptrajopt_tpu_torch.spatial import invt, qangle_deg, r2quat, r2rpy, transform_points

COLLISION_WEIGHT = 10.0  # the obstacle term's weight (gto/ik_solver.py:69)


class IKSolver:
    def __init__(
        self,
        robot,
        link_ee: str,
        link_gripper: str,
        collision_avoidance: bool = True,
        cost: str = "point",
        interp: str = "trilinear",
        iterations: int = 50,
        num_seeds: int = 8,
    ):
        if cost not in ("point", "quaternion", "rpy"):
            raise ValueError(f"unknown IK cost '{cost}'")
        if interp not in ("trilinear", "nearest"):
            raise ValueError(f"unknown interp mode '{interp}'")
        self.robot = robot
        self.link_ee = link_ee
        self.link_gripper = link_gripper
        self.collision_avoidance = collision_avoidance
        self.cost = cost
        self.interp = interp
        self.iterations = iterations
        self.num_seeds = num_seeds
        self.gripper_points = robot.gripper_points(link_gripper)
        self._solve = None
        self._grid = None

    # -- problem construction -------------------------------------------------

    def setup_optimization(self, grid=None) -> None:
        """Build the batched solver for a field geometry (`grid` defaults
        to the robot's)."""
        robot = self.robot
        grid = grid or getattr(robot, "grid", None)
        if self.collision_avoidance and grid is None:
            raise ValueError("collision avoidance needs a voxel grid")
        self._grid = grid
        ee_frame = robot.frame_of(self.link_ee)
        grip_frame = robot.frame_of(self.link_gripper)
        gpts = self.gripper_points
        cost = self.cost

        def residual(q_opt, p):
            comps = robot.fk_components(robot.assemble_q(q_opt, p["q_param"]))
            T_ee = robot.frame_matrix(comps, ee_frame)
            T_grip = robot.frame_matrix(comps, grip_frame)
            gripper_tf = invt(T_ee) @ T_grip
            tf = T_ee @ gripper_tf
            goal = p["tf_goal"]
            if cost == "point":
                pts = transform_points(tf, gpts)
                pts_goal = transform_points(goal @ gripper_tf, gpts)
                return (pts - pts_goal).reshape(-1)
            if cost == "quaternion":
                rot = 1.0 - torch.sum(r2quat(tf[:3, :3]) * r2quat(goal[:3, :3])) ** 2
                return torch.cat([tf[:3, 3] - goal[:3, 3], torch.sqrt(torch.clamp(rot, min=1e-12))[None]])
            return torch.cat([tf[:3, 3] - goal[:3, 3], r2rpy(tf[:3, :3]) - r2rpy(goal[:3, :3])])

        value_term = self._make_value_term(grid) if self.collision_avoidance else None
        solver = make_box_lm_solver(residual, LMConfig(iterations=self.iterations), value_term)
        dtype, dev = robot.dtype, robot.device
        lo = torch.as_tensor(robot.lower_optimized_joint_limits, dtype=dtype, device=dev)
        hi = torch.as_tensor(robot.upper_optimized_joint_limits, dtype=dtype, device=dev)
        # finite sampling range of the multistart restarts
        self._restart_lo = torch.clamp(lo, -3.2, 3.2)
        self._restart_hi = torch.clamp(hi, -3.2, 3.2)
        self._solve = lambda q0_opt, params, shared: solver(q0_opt, lo, hi, params, shared)

    def _make_value_term(self, grid):
        """(value, value_and_grad) of the obstacle term 10 * sum(field at
        every body point) for opt/lm.py. Points of x (B, ..., n) ride on
        their problem's q_param and base_position."""
        robot = self.robot
        trilinear = self.interp == "trilinear"

        def per_problem(params, x):
            lead = (x.shape[0],) + (1,) * (x.dim() - 2)
            return params["q_param"].reshape(lead + (-1,)), params["base_position"].reshape(lead + (3,))

        def lookup(shared, x, y, z):
            if trilinear:
                return field_lookup_packed_soa_grad(
                    shared["packed_obstacle"], x, y, z, grid.origin, grid.shape, grid.resolution
                )
            val = grid.lookup_nearest(shared["sdf_cost_obstacle"], torch.stack([x, y, z], dim=-1))
            return (val,)

        def value(x, params, shared):
            q_param, base = per_problem(params, x)
            px, py, pz = robot.surface_points_soa(robot.fk_components(robot.assemble_q(x, q_param)), base)
            return COLLISION_WEIGHT * torch.sum(lookup(shared, px, py, pz)[0], dim=-1)

        def pts_of(q_opt, q_param, base):
            xx, yy, zz = robot.surface_points_soa(robot.fk_components(robot.assemble_q(q_opt, q_param)), base)
            out = torch.stack([xx, yy, zz], dim=-1)  # (P, 3)
            return out, out

        def value_and_grad(x, params, shared):
            if not trilinear:  # floor indexing: no gradient
                return value(x, params, shared), torch.zeros_like(x)
            q_param, base = per_problem(params, x)
            # one batched FK trace gives the body points and their Jacobians
            J_pts, pts = vmap(jacfwd(pts_of, has_aux=True))(x, q_param, base)  # (B, P, 3, n), (B, P, 3)
            pts = pts.contiguous()  # x / y / z views, 3 elements apart
            val, gx, gy, gz = lookup(shared, pts[..., 0], pts[..., 1], pts[..., 2])
            grad = torch.stack([gx, gy, gz], dim=-1)
            dv = COLLISION_WEIGHT * torch.einsum("bpc,bpcn->bn", grad, J_pts)
            return COLLISION_WEIGHT * torch.sum(val, dim=-1), dv

        return value, value_and_grad

    # -- solve API ------------------------------------------------------------

    def _tensor(self, a):
        """`a` in the robot's dtype on its device; a tensor already there is
        returned as it is, so a screen given device tensors copies nothing
        from the host."""
        if torch.is_tensor(a):
            return a.to(device=self.robot.device, dtype=self.robot.dtype)
        return torch.as_tensor(a, dtype=self.robot.dtype, device=self.robot.device)

    def _shared(self, sdf_cost_obstacle):
        """The obstacle field as the value term reads it: packed once for
        the whole batch (trilinear) or flat (nearest)."""
        if not self.collision_avoidance:
            return None
        if sdf_cost_obstacle is None:
            raise ValueError("collision avoidance needs sdf_cost_obstacle")
        field = self._tensor(sdf_cost_obstacle)
        if self.interp == "trilinear":
            return {"packed_obstacle": self._grid.pack(field)}
        return {"sdf_cost_obstacle": field}

    def col_cost(self, q, sdf_cost_obstacle, base_position=(0.0, 0.0, 0.0)):
        """(B,) unweighted sum of the floor-indexed obstacle field over the
        body points of configurations q (B, ndof)."""
        pts = self.robot.fk_surface_points(q, self._tensor(base_position))
        return torch.sum(self._grid.lookup_nearest(self._tensor(sdf_cost_obstacle), pts), dim=-1)

    def solve_ik_batch(
        self, q_0, RTs, sdf_cost_obstacle=None, base_position=(0.0, 0.0, 0.0),
        multistart: bool = False, seed: int = 0, restarts=None,
    ):
        """q_0 (ndof,) shared seed or (B, ndof); RTs (B, 4, 4) goals in the
        robot base frame; sdf_cost_obstacle the flat (S,) obstacle field on
        the solver's grid (collision avoidance only); base_position (3,) the
        robot base in the field's frame. Returns tensors (q (B, ndof),
        err_pos (B,), err_rot_deg (B,), col_cost (B,); zeros without
        collision avoidance).

        multistart: each goal also starts from num_seeds - 1 restarts,
        uniform in the joint limits clipped to +-3.2, drawn from a
        torch.Generator seeded with `seed` on the solver's device, or given
        as `restarts` (B, num_seeds - 1, n_opt); all B * num_seeds seeds
        are one LM batch and the lowest cost wins (the first on a tie)."""
        if self._solve is None:
            self.setup_optimization()
        robot = self.robot
        B = RTs.shape[0]
        q_0 = q_0.expand(B, robot.ndof)
        q_param = robot.extract_parameter_dimensions(q_0)
        q0_opt = robot.extract_optimized_dimensions(q_0)
        params = {"tf_goal": RTs, "q_param": q_param}
        if self.collision_avoidance:
            params["base_position"] = self._tensor(base_position).expand(B, 3)
        shared = self._shared(sdf_cost_obstacle)
        if not multistart:
            q_opt, _, _ = self._solve(q0_opt, params, shared)
        else:
            S = self.num_seeds
            if restarts is None:
                gen = torch.Generator(device=robot.device).manual_seed(seed)
                u = torch.rand(
                    (B, S - 1, q0_opt.shape[-1]), generator=gen, dtype=robot.dtype, device=robot.device
                )
                restarts = self._restart_lo + u * (self._restart_hi - self._restart_lo)
            seeds = torch.cat([q0_opt[:, None], restarts.to(q0_opt.dtype)], dim=1)  # (B, S, n)
            params = {k: v.repeat_interleave(S, dim=0) for k, v in params.items()}
            xs, costs, _ = self._solve(seeds.reshape(B * S, -1), params, shared)
            best = torch.argmin(costs.reshape(B, S), dim=1)
            q_opt = xs.reshape(B, S, -1)[torch.arange(B, device=xs.device), best]
        q = robot.assemble_q(q_opt, q_param)
        T = robot.get_global_link_transform(self.link_ee, q)
        err_pos = torch.linalg.vector_norm(RTs[:, :3, 3] - T[:, :3, 3], dim=-1)
        err_rot = qangle_deg(r2quat(RTs[:, :3, :3]), r2quat(T[:, :3, :3]))
        if self.collision_avoidance:
            col = self.col_cost(q, sdf_cost_obstacle, base_position)
        else:
            col = torch.zeros_like(err_pos)
        return q, err_pos, err_rot, col

    def solve_ik(
        self, q_0, RT, sdf_cost_obstacle=None, base_position=(0.0, 0.0, 0.0), verbose: bool = True,
        multistart: bool = False, seed: int = 0, restarts: Optional[torch.Tensor] = None,
    ):
        """Single-goal IK: q_0 (ndof,), RT (4, 4). Returns (q (ndof,) tensor,
        err_pos, err_rot_deg, col_cost) with three floats; `restarts`
        (num_seeds - 1, n_opt) if given."""
        q, err_pos, err_rot, col = self.solve_ik_batch(
            q_0, RT[None], sdf_cost_obstacle, base_position, multistart, seed,
            None if restarts is None else restarts[None],
        )
        err_pos, err_rot, col = float(err_pos[0]), float(err_rot[0]), float(col[0])
        if verbose:
            print("IK solution:", q[0].cpu().numpy())
            print("position error", err_pos)
            print("rotation error in degree", err_rot)
            print("collision cost", col)
        return q[0], err_pos, err_rot, col

    def solve_fk(self, q):
        """The end-effector's (4, 4) pose at q (ndof,)."""
        return self.robot.get_global_link_transform(self.link_ee, self._tensor(q).reshape(-1))
