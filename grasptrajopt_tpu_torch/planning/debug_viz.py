"""Planning debug visualizers (host-side, matplotlib backend).

Port of grasptrajopt_tpu/planning/debug_viz.py on the port's robot model
(`compute_fk_surface_points` returns the host points alone) and
`spatial.r2quat`.

Parity with the viewer helpers in the reference's gto/utils.py:85-280
(debug_plan, visualize_plan, visualize_pose, visualize_grasp,
visualize_standoff): scene point cloud + robot surface points colored by
SDF-cost violation + grasp poses, rendered with this framework's
Visualizer. Each helper saves to PNG when `save_path` is given (headless)
or opens an interactive window otherwise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from grasptrajopt_tpu_torch.viz import Visualizer


def _finish(vis: Visualizer, save_path: Optional[str]):
    if save_path:
        vis.save(save_path)
        vis.close()
    else:
        vis.start()


def visualize_pose(robot, base_position, q, depth_pc, save_path: Optional[str] = None):
    """Robot at configuration q against the scene cloud (gto/utils.py:181)."""
    vis = Visualizer(camera_position=[3, 0, 3])
    vis.grid_floor()
    vis.points(depth_pc.points[::20], rgb=[0.7, 0.7, 0.7], size=1)
    pts = robot.compute_fk_surface_points(np.asarray(q).reshape(-1))
    vis.points(pts + np.asarray(base_position).reshape(1, 3), rgb=[1, 1, 0], size=4)
    vis.robot(robot, q=np.asarray(q).reshape(-1), base_position=base_position, alpha=0.9)
    _finish(vis, save_path)


def debug_plan(
    robot,
    gripper_model,
    base_position,
    plan,
    depth_pc,
    sdf_cost,
    RT_grasps_world=None,
    start_step: int = 45,
    save_path: Optional[str] = None,
):
    """Per-step SDF-violation view of a plan's tail (gto/utils.py:85-178):
    body points in collision render red, free points yellow; occupied grid
    cells cyan. Returns the per-step costs."""
    plan = np.asarray(plan)
    base_position = np.asarray(base_position)
    costs = []
    T = plan.shape[1]
    vis = Visualizer(camera_position=[3, 0, 3])
    vis.grid_floor()
    vis.points(depth_pc.points[::20], rgb=[0.8, 0.8, 0.8], size=1)
    for i in range(start_step, T):
        q = plan[:, i]
        pts = robot.compute_fk_surface_points(q)
        pts_world = pts + base_position.reshape(1, 3)
        offsets = robot.points_to_offsets_numpy(pts_world)
        vals = np.asarray(sdf_cost)[offsets]
        costs.append(float(vals.sum()))
        bad = vals > 0
        if bad.any():
            vis.points(pts_world[bad], rgb=[1, 0, 0], size=5)
        vis.points(pts_world[~bad], rgb=[1, 1, 0], size=2)
    occupied = np.asarray(sdf_cost) > 0
    if occupied.any():
        vis.points(robot.workspace_points[occupied][::5], rgb=[0, 1, 1], size=2)
    if RT_grasps_world is not None:
        for RT in np.asarray(RT_grasps_world)[:4]:
            vis.sphere(radius=0.015, position=RT[:3, 3], rgb=[0, 1, 0])
    _finish(vis, save_path)
    return costs


def visualize_plan(robot, gripper_model, base_position, plan, depth_pc, RT_grasps_world, save_path: Optional[str] = None):
    """Ghost trajectory + grasp markers over the scene (gto/utils.py:181-230)."""
    plan = np.asarray(plan)
    vis = Visualizer(camera_position=[3, 0, 3])
    vis.grid_floor()
    vis.points(depth_pc.points[::20], rgb=[0.8, 0.8, 0.8], size=1)
    n = plan.shape[1]
    index = list(range(0, n, 10))
    if index[-1] != n - 1:
        index.append(n - 1)
    vis.robot_traj(robot, plan[:, index], alpha_spec={"style": "A"}, base_position=base_position)
    for RT in np.asarray(RT_grasps_world)[:6]:
        vis.sphere(radius=0.015, position=RT[:3, 3], rgb=[0, 1, 0])
    _finish(vis, save_path)


def visualize_grasp(cfg, robot, gripper_model, base_position, q, depth_pc, RT_grasp, save_path: Optional[str] = None):
    """One grasp pose: gripper model placed at the grasp over the scene
    (gto/utils.py:233-259)."""
    from grasptrajopt_tpu_torch.spatial import r2quat

    vis = Visualizer(camera_position=[3, 2, 3])
    vis.grid_floor()
    vis.points(depth_pc.points[::20], rgb=[0.8, 0.8, 0.8], size=1)
    RT = np.asarray(RT_grasp)
    quat = r2quat(torch.as_tensor(RT[:3, :3])).numpy()  # xyzw
    vis.robot(
        gripper_model,
        q=cfg.get("gripper_open_offsets", [0.04, 0.04]),
        base_position=RT[:3, 3],
        base_orientation=quat,
    )
    vis.robot(robot, q=np.asarray(q).reshape(-1), base_position=base_position, alpha=0.4)
    _finish(vis, save_path)


def visualize_standoff(cfg, gripper_model, RT, RT_off, save_path: Optional[str] = None):
    """Grasp pose and its standoff pose side by side (gto/utils.py:262-280)."""
    from grasptrajopt_tpu_torch.spatial import r2quat

    vis = Visualizer(camera_position=[1.5, 1.5, 1.5])
    vis.grid_floor()
    for T, alpha in [(np.asarray(RT), 1.0), (np.asarray(RT_off), 0.4)]:
        quat = r2quat(torch.as_tensor(T[:3, :3])).numpy()
        vis.robot(
            gripper_model,
            q=cfg.get("gripper_open_offsets", [0.04, 0.04]),
            base_position=T[:3, 3],
            base_orientation=quat,
            alpha=alpha,
        )
    _finish(vis, save_path)
