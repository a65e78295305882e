"""Plan replay evaluation: collision checking and goal-reach scoring.

Port of grasptrajopt_tpu/planning/evaluate.py. Every step of a recorded
plan is FK'd to body surface points and checked against the obstacle-only
depth cloud; a step with more than `threshold_points` points at sdf < 0
is a collision, leaving out the points already inside at step 0 (resting
contacts). Goal reach follows the IK acceptance gates. A replay of n plans
is one FK call and one signed-distance query (one K1 launch on the card).

Plans cross this module's interface in the JAX package's host layout:
numpy (ndof, T), or (n, ndof, T) for a batch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from grasptrajopt_tpu_torch.spatial import qangle_deg, r2quat


def _replay_inside(robot, plans, depth_pc_obstacle, base_position):
    """(n, T) numpy counts of body points inside the cloud at each step of
    plans (n, ndof, T), points already inside at step 0 left out."""
    n, ndof, T = plans.shape
    Q = torch.as_tensor(plans.transpose(0, 2, 1).reshape(n * T, ndof), dtype=robot.dtype, device=robot.device)
    base = torch.as_tensor(np.asarray(base_position), dtype=robot.dtype, device=robot.device)
    pts = robot.fk_surface_points(Q, base_position=base)  # (n*T, P, 3)
    P = pts.shape[1]
    inside = (depth_pc_obstacle.get_sdf(pts.reshape(-1, 3)) < 0).reshape(n, T, P)
    return (inside & ~inside[:, :1, :]).sum(dim=2).cpu().numpy()


def _rot_errors(robot, RT_goals, T_ee):
    """Rotation errors in degrees between goal frames (n, 4, 4) and
    end-effector frames (n or 1, 4, 4)."""
    q_goals = r2quat(torch.as_tensor(RT_goals[:, :3, :3], dtype=robot.dtype, device=robot.device))
    q_ee = r2quat(torch.as_tensor(T_ee[:, :3, :3], dtype=robot.dtype, device=robot.device))
    return qangle_deg(q_goals, q_ee).cpu().numpy()


def check_plan_collision(
    robot,
    plan: np.ndarray,
    depth_pc_obstacle,
    base_position=(0.0, 0.0, 0.0),
    threshold_points: int = 5,
) -> Tuple[bool, np.ndarray]:
    """Replay a (ndof, T) plan against the obstacle depth cloud. Returns
    (collision, per-step inside-point counts (T,)): a collision when a
    step has more than `threshold_points` surface points with sdf < 0,
    excluding the points already inside at step 0 (the robot's resting
    contacts, e.g. a base on the observed support plane)."""
    counts = _replay_inside(robot, np.asarray(plan)[None], depth_pc_obstacle, base_position)[0]
    return bool((counts > threshold_points).any()), counts


def goalset_reach_errors(
    robot, link_ee: str, q_final, RT_goals: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-goal final end-effector errors over the grasp set: (err_pos (n,)
    m, err_rot (n,) deg). Goal sets hold symmetric grasps, so success
    gates on ANY goal meeting both tolerances."""
    q = torch.as_tensor(np.asarray(q_final), dtype=robot.dtype, device=robot.device).reshape(-1)
    T_ee = robot.get_global_link_transform(link_ee, q).cpu().numpy()
    RT_goals = np.asarray(RT_goals)
    d = np.linalg.norm(RT_goals[:, :3, 3] - T_ee[:3, 3], axis=1)
    return d, _rot_errors(robot, RT_goals, np.repeat(T_ee[None], len(d), axis=0))


def score_plans_pergoal(
    robot,
    link_ee: str,
    plans: np.ndarray,
    RT_goals: np.ndarray,
    depth_pc_obstacle,
    base_position=(0.0, 0.0, 0.0),
    pos_tol: float = 0.02,
    rot_tol_deg: float = 10.0,
    threshold_points: int = 5,
) -> list:
    """Score n plans (n, ndof, T), each against ITS OWN goal RT_goals
    (n, 4, 4), in one replay. Returns n dicts with score_plan's fields."""
    plans = np.asarray(plans)
    RT_goals = np.asarray(RT_goals)
    counts = _replay_inside(robot, plans, depth_pc_obstacle, base_position)  # (n, T)
    collisions = (counts > threshold_points).any(axis=1)
    finals = torch.as_tensor(plans[:, :, -1], dtype=robot.dtype, device=robot.device)
    T_ee = robot.get_global_link_transform(link_ee, finals).cpu().numpy()  # (n, 4, 4)
    d = np.linalg.norm(RT_goals[:, :3, 3] - T_ee[:, :3, 3], axis=1)
    rot = _rot_errors(robot, RT_goals, T_ee)

    out = []
    for i in range(plans.shape[0]):
        reached = bool((d[i] < pos_tol) and (rot[i] < rot_tol_deg))
        collision = bool(collisions[i])
        out.append({
            "err_pos": float(d[i]),
            "err_rot": float(rot[i]),
            "reached": reached,
            "collision": collision,
            "max_inside_points": int(counts[i].max()),
            "reward": int(reached and not collision),
        })
    return out


def score_plan(
    robot,
    link_ee: str,
    plan: np.ndarray,
    RT_goals: np.ndarray,
    depth_pc_obstacle,
    base_position=(0.0, 0.0, 0.0),
    pos_tol: float = 0.02,
    rot_tol_deg: float = 10.0,
    threshold_points: int = 5,
) -> dict:
    """Goal reach over the goal set (base-frame goals) + collision replay
    of one (ndof, T) plan. reward = reached AND collision-free."""
    d, rot = goalset_reach_errors(robot, link_ee, plan[:, -1], RT_goals)
    within = (d < pos_tol) & (rot < rot_tol_deg)
    reached = bool(within.any())
    # the errors reported are the reached goal's when any goal meets both
    # tolerances, so (err_pos, err_rot) always agree with `reached`
    score = d + rot * 2e-3
    if reached:
        score = np.where(within, score, np.inf)
    best = int(np.argmin(score))
    collision, counts = check_plan_collision(
        robot, plan, depth_pc_obstacle, base_position, threshold_points
    )
    return {
        "err_pos": float(d[best]),
        "err_rot": float(rot[best]),
        "reached": reached,
        "collision": bool(collision),
        "max_inside_points": int(counts.max()),
        "reward": int(reached and not collision),
    }
