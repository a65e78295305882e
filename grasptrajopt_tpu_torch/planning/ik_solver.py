"""IKSolver: point-matching inverse kinematics over a batch of grasps.

Port of grasptrajopt_tpu/planning/ik_solver.py for the IK screen of the
perception-to-plan path: the point cost (the gripper link's surface points
at fk(q) against the same points placed at the goal pose), single seed,
no collision term. One projected-LM solve covers the whole grasp batch.
"""

from __future__ import annotations

import torch

from grasptrajopt_tpu_torch.opt.lm import LMConfig, make_box_lm_solver
from grasptrajopt_tpu_torch.spatial import invt, qangle_deg, r2quat, transform_points


class IKSolver:
    def __init__(self, robot, link_ee: str, link_gripper: str, iterations: int = 50):
        self.robot = robot
        self.link_ee = link_ee
        self.link_gripper = link_gripper
        self.iterations = iterations
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
        self._solve = lambda q0_opt, params: solver(q0_opt, lo, hi, params)

    def solve_ik_batch(self, q_0, RTs):
        """q_0 (ndof,) shared seed or (B, ndof); RTs (B, 4, 4) goals in the
        robot base frame. Returns tensors (q (B, ndof), err_pos (B,),
        err_rot_deg (B,)) with the IK screen's error metrics."""
        if self._solve is None:
            self.setup_optimization()
        robot = self.robot
        B = RTs.shape[0]
        q_0 = q_0.expand(B, robot.ndof)
        q_param = robot.extract_parameter_dimensions(q_0)
        params = {"tf_goal": RTs, "q_param": q_param}
        q_opt, _, _ = self._solve(robot.extract_optimized_dimensions(q_0), params)
        q = robot.assemble_q(q_opt, q_param)
        T = robot.get_global_link_transform(self.link_ee, q)
        err_pos = torch.linalg.vector_norm(RTs[:, :3, 3] - T[:, :3, 3], dim=-1)
        err_rot = qangle_deg(r2quat(RTs[:, :3, :3]), r2quat(T[:, :3, :3]))
        return q, err_pos, err_rot
