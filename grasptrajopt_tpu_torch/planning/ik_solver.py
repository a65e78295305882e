"""IKSolver: point-matching inverse kinematics over a batch of grasps.

Port of grasptrajopt_tpu/planning/ik_solver.py for the IK screen and the
bench's warm start: the point cost (the gripper link's surface points at
fk(q) against the same points placed at the goal pose), no collision term
(as the bench and the pipeline run it). One projected-LM solve covers the
whole grasp batch; with multistart, every goal's seed and its random
restarts are one LM batch too.
"""

from __future__ import annotations

import torch

from grasptrajopt_tpu_torch.opt.lm import LMConfig, make_box_lm_solver
from grasptrajopt_tpu_torch.spatial import invt, qangle_deg, r2quat, transform_points


class IKSolver:
    def __init__(
        self, robot, link_ee: str, link_gripper: str, iterations: int = 50, num_seeds: int = 8
    ):
        self.robot = robot
        self.link_ee = link_ee
        self.link_gripper = link_gripper
        self.iterations = iterations
        self.num_seeds = num_seeds
        self.gripper_points = robot.gripper_points(link_gripper)
        self._solve = None

    def setup_optimization(self) -> None:
        robot = self.robot
        ee_frame = robot.frame_of(self.link_ee)
        grip_frame = robot.frame_of(self.link_gripper)
        gpts = self.gripper_points

        def residual(q_opt, p):
            comps = robot.fk_components(robot.assemble_q(q_opt, p["q_param"]))
            T_ee = robot.frame_matrix(comps, ee_frame)
            T_grip = robot.frame_matrix(comps, grip_frame)
            gripper_tf = invt(T_ee) @ T_grip
            pts = transform_points(T_ee @ gripper_tf, gpts)
            pts_goal = transform_points(p["tf_goal"] @ gripper_tf, gpts)
            return (pts - pts_goal).reshape(-1)

        solver = make_box_lm_solver(residual, LMConfig(iterations=self.iterations))
        dtype, dev = robot.dtype, robot.device
        lo = torch.as_tensor(robot.lower_optimized_joint_limits, dtype=dtype, device=dev)
        hi = torch.as_tensor(robot.upper_optimized_joint_limits, dtype=dtype, device=dev)
        # finite sampling range of the multistart restarts
        self._restart_lo = torch.clamp(lo, -3.2, 3.2)
        self._restart_hi = torch.clamp(hi, -3.2, 3.2)
        self._solve = lambda q0_opt, params: solver(q0_opt, lo, hi, params)

    def solve_ik_batch(self, q_0, RTs, multistart: bool = False, seed: int = 0, restarts=None):
        """q_0 (ndof,) shared seed or (B, ndof); RTs (B, 4, 4) goals in the
        robot base frame. Returns tensors (q (B, ndof), err_pos (B,),
        err_rot_deg (B,)) with the IK screen's error metrics.

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
        if not multistart:
            q_opt, _, _ = self._solve(q0_opt, {"tf_goal": RTs, "q_param": q_param})
        else:
            S = self.num_seeds
            if restarts is None:
                gen = torch.Generator(device=robot.device).manual_seed(seed)
                u = torch.rand(
                    (B, S - 1, q0_opt.shape[-1]), generator=gen, dtype=robot.dtype, device=robot.device
                )
                restarts = self._restart_lo + u * (self._restart_hi - self._restart_lo)
            seeds = torch.cat([q0_opt[:, None], restarts.to(q0_opt.dtype)], dim=1)  # (B, S, n)
            params = {
                "tf_goal": RTs.repeat_interleave(S, dim=0),
                "q_param": q_param.repeat_interleave(S, dim=0),
            }
            xs, costs, _ = self._solve(seeds.reshape(B * S, -1), params)
            best = torch.argmin(costs.reshape(B, S), dim=1)
            q_opt = xs.reshape(B, S, -1)[torch.arange(B, device=xs.device), best]
        q = robot.assemble_q(q_opt, q_param)
        T = robot.get_global_link_transform(self.link_ee, q)
        err_pos = torch.linalg.vector_norm(RTs[:, :3, 3] - T[:, :3, 3], dim=-1)
        err_rot = qangle_deg(r2quat(RTs[:, :3, :3]), r2quat(T[:, :3, :3]))
        return q, err_pos, err_rot

    def solve_ik(self, q_0, RT, multistart: bool = False, seed: int = 0, restarts=None):
        """Single-goal IK: q_0 (ndof,), RT (4, 4). Returns (q (ndof,),
        err_pos, err_rot_deg) as a tensor and two floats; `restarts`
        (num_seeds - 1, n_opt) if given."""
        q, err_pos, err_rot = self.solve_ik_batch(
            q_0, RT[None], multistart, seed, None if restarts is None else restarts[None]
        )
        return q[0], float(err_pos[0]), float(err_rot[0])
