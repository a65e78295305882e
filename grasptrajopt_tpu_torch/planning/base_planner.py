"""BasePlanner: mobile-base placement for a set of grasp goals.

Port of grasptrajopt_tpu/planning/base_planner.py. One problem is a base
pose (x, y, theta) plus one arm configuration per goal. Its residual is
the gripper link's surface points at fk(q_i) against the same points at
goal i placed in the candidate base frame, tf_base @ tf_goal_i @
gripper_tf with tf_base = rt2tr(rotz(theta), [x, y, 0]), plus
sqrt(w) * (x, y, theta): an effort penalty w * |(x, y, theta)|^2. Bounds:
x and y +-1e9, theta +-pi, the arm's joint limits.

The solve is the batch-first projected LM of opt/lm.py: one problem for
`plan_goalset`, or B candidate grasp subsets at once
(`plan_goalset_batch`, the JAX package's vmapped `_solver_batch`). The
base LM and the occupancy lookup run no kernel in the JAX package, so
they stay plain PyTorch here; the occupancy grid itself is K3's
(GTORobotModel.setup_occupancy_grid).

Diagnostics of `plan_goalset`, as in the JAX package: per goal the
position and rotation error of the gripper against the goal at the new
base, and the occupancy cost of the robot at the CURRENT configuration
qc placed by the inverse of the solved base pose.
"""

from __future__ import annotations

import numpy as np
import torch

from grasptrajopt_tpu_torch.opt.lm import LMConfig, make_box_lm_solver
from grasptrajopt_tpu_torch.planning.utils import rotZ
from grasptrajopt_tpu_torch.spatial import invt, qangle_deg, r2quat, rotz, rt2tr, transform_points


class BasePlanner:
    def __init__(self, robot, link_ee: str, link_gripper: str, iterations: int = 100):
        self.robot = robot
        self.robot_name = robot.name
        self.link_ee = link_ee
        self.link_gripper = link_gripper
        self.iterations = iterations
        self.gripper_points = robot.gripper_points(link_gripper)
        self.task_name = "base_pose_estimator"
        self._solve = None
        self._goal_size = None

    def setup_optimization(self, goal_size: int = 1, base_effort_weight: float = 0.01) -> None:
        """Build the solver for `goal_size` goals a problem."""
        robot = self.robot
        dtype, dev = robot.dtype, robot.device
        n_opt = robot.num_opt_joints
        ee_frame = robot.frame_of(self.link_ee)
        grip_frame = robot.frame_of(self.link_gripper)
        gpts = self.gripper_points
        sqrt_w = float(np.sqrt(base_effort_weight))

        def residual(x, p):
            base = x[:3]
            Q_opt = x[3:].reshape(goal_size, n_opt)
            t = torch.stack([base[0], base[1], torch.zeros_like(base[0])])
            tf_base = rt2tr(rotz(base[2]), t)
            frames = robot.fk_all(robot.assemble_q(Q_opt, p["q_param"]))  # (G, F, 4, 4)
            T_grip = frames[:, grip_frame]
            gripper_tf = invt(frames[:, ee_frame]) @ T_grip
            pts_cur = transform_points(T_grip, gpts)
            pts_goal = transform_points(tf_base @ p["tf_goal"] @ gripper_tf, gpts)
            return torch.cat([(pts_cur - pts_goal).reshape(-1), sqrt_w * base])

        solver = make_box_lm_solver(residual, LMConfig(iterations=self.iterations))
        big = 1e9
        lo = np.concatenate([[-big, -big, -np.pi], np.tile(robot.lower_optimized_joint_limits, goal_size)])
        hi = np.concatenate([[big, big, np.pi], np.tile(robot.upper_optimized_joint_limits, goal_size)])
        lo = torch.as_tensor(lo, dtype=dtype, device=dev)
        hi = torch.as_tensor(hi, dtype=dtype, device=dev)
        self._solve = lambda x0, params: solver(x0, lo, hi, params)
        self._goal_size = goal_size

    def _problems(self, qc, RTs):
        """(x0 (B, 3 + n * n_opt), params, q_param) for goal sets RTs
        (B, n, 4, 4) from the current configuration qc (ndof,): the base
        at the origin, every arm at qc."""
        robot = self.robot
        RTs = torch.as_tensor(np.asarray(RTs), dtype=robot.dtype, device=robot.device)
        B, n = RTs.shape[:2]
        if self._goal_size != n:
            self.setup_optimization(goal_size=n)
        qc = torch.as_tensor(np.asarray(qc), dtype=robot.dtype, device=robot.device).reshape(-1)
        q_param = robot.extract_parameter_dimensions(qc)
        qc_opt = robot.extract_optimized_dimensions(qc)
        x0 = torch.cat([torch.zeros(3, dtype=robot.dtype, device=robot.device), qc_opt.repeat(n)])
        params = {"tf_goal": RTs, "q_param": q_param.expand(B, -1)}
        return x0.expand(B, -1).contiguous(), params, q_param

    def plan_goalset_batch(self, qc, RTs):
        """Solve B candidate goal sets RTs (B, n, 4, 4) at once from qc
        (ndof,). Returns (Q (B, ndof, n), y (B, 3) base poses, cost (B,))
        as host numpy."""
        x0, params, q_param = self._problems(qc, RTs)
        x, cost, _ = self._solve(x0, params)
        B, n = params["tf_goal"].shape[:2]
        Q_full = self.robot.assemble_q(x[:, 3:].reshape(B, n, -1), q_param)  # (B, n, ndof)
        return (Q_full.transpose(1, 2).cpu().numpy(), x[:, :3].cpu().numpy().astype(np.float64),
                cost.cpu().numpy())

    def plan_goalset(self, qc, RTs, verbose: bool = True):
        """Base placement for goal poses RTs (n, 4, 4) from the current
        configuration qc (ndof,). Returns (Q (ndof, n), y (3,) the base
        pose, err_pos (n,), err_rot (n,) degrees, col_cost float)."""
        robot = self.robot
        x0, params, q_param = self._problems(qc, np.asarray(RTs)[None])
        x, _, _ = self._solve(x0, params)
        RTs = params["tf_goal"][0]
        n = RTs.shape[0]
        y = x[0, :3].cpu().numpy().astype(np.float64)
        Q_full = robot.assemble_q(x[0, 3:].reshape(n, robot.num_opt_joints), q_param)  # (n, ndof)

        RT_base = rotZ(y[2])
        RT_base[0, 3] = y[0]
        RT_base[1, 3] = y[1]
        RT_base_t = torch.as_tensor(RT_base, dtype=robot.dtype, device=robot.device)
        frames = robot.fk_all(Q_full)
        T_grip = frames[:, robot.frame_of(self.link_gripper)]
        T_ee = frames[:, robot.frame_of(self.link_ee)]
        gripper_tf = invt(T_ee) @ T_grip
        RT_goal = RT_base_t @ RTs @ gripper_tf
        err_pos = torch.linalg.vector_norm(RT_goal[:, :3, 3] - T_grip[:, :3, 3], dim=-1).cpu().numpy()
        err_rot = qangle_deg(r2quat(RT_goal[:, :3, :3]), r2quat(T_grip[:, :3, :3])).cpu().numpy()

        col_cost = 0.0
        if robot.occupancy is not None and robot.occupancy_grid is not None:
            # at qc, as the JAX package computes it, not at the solution
            cost = robot.occupancy_cost(np.asarray(qc), np.linalg.inv(RT_base), robot.occupancy_grid)
            col_cost = float(cost)

        if verbose:
            for i in range(n):
                print(f"grasp {i}: position error {err_pos[i]:.4f}, rotation error {err_rot[i]:.2f} deg")
            print("base pose solution:", y)
            print("collision cost", col_cost)
        return Q_full.T.cpu().numpy(), y, err_pos, err_rot, col_cost
