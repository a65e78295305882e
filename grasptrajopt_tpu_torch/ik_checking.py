"""IK-only screening over the SceneReplica benchmark, on the port.

Port of examples/ik_checking.py (the reference's pybullet_ik_checking.py):
per object of one scene, render, build the obstacle field (one K1 launch
on the card) and report how many grasp candidates pass the IK screen
(position error < 1 cm, rotation error < 5 degrees); no trajectory
optimization and no execution. The whole grasp set screens as one batch.

    python -m grasptrajopt_tpu_torch.ik_checking -r synth7 --assets_dir TREE -s 10
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from grasptrajopt_tpu_torch.envs.camera import pose_from_position_quaternion
from grasptrajopt_tpu_torch.envs.grasps import load_grasps
from grasptrajopt_tpu_torch.fields.depth_point_cloud import DepthPointCloud
from grasptrajopt_tpu_torch.planning.ik_solver import IKSolver
from grasptrajopt_tpu_torch.planning.utils import get_data_dir
from grasptrajopt_tpu_torch.testing import SYNTH_SCENEREPLICA_CONFIG
from grasptrajopt_tpu_torch.utils.cli import (
    asset_path,
    build_models,
    clock,
    require_pybullet,
    resolve_device,
    sim_robot_name,
)


def make_args(argv=None):
    parser = argparse.ArgumentParser(description="SceneReplica IK screening on the port")
    parser.add_argument("-r", "--robot", default="panda", help="panda, fetch or synth7")
    parser.add_argument("-d", "--data_dir", default=None)
    parser.add_argument("-s", "--scene_id", type=int, default=10)
    parser.add_argument("-t", "--scene_type", default="tabletop")
    parser.add_argument("--assets_dir", default=None)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default): float32 on the card; cpu: float64, the plain kernels")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns {object: (found (n,) host bool, seconds)}."""
    args = make_args(argv)
    require_pybullet()
    device = resolve_device(args.device)

    from grasptrajopt_tpu_torch.envs.scene_replica import SceneReplicaEnv

    assets_dir = args.assets_dir or get_data_dir()
    data_dir = args.data_dir or assets_dir
    robot, _, cfg = build_models(args.robot, assets_dir, device=device, synth_config=SYNTH_SCENEREPLICA_CONFIG)
    sim_name = sim_robot_name(args.robot, cfg)
    env = SceneReplicaEnv(asset_path(assets_dir, cfg, "urdf_robot_path"), data_dir, assets_dir, sim_name,
                          args.scene_type)
    ik_solver = IKSolver(robot, cfg["link_ee"], cfg["link_gripper"], collision_avoidance=False)
    ik_solver.setup_optimization()

    meta = env.setup_scene(args.scene_id)
    ordering = "nearest_first" if args.scene_type == "tabletop" else "random"
    object_order = meta[ordering][0].split(",")
    out = {}
    for object_name in object_order:
        rgba, depth, mask, cam_pose, K = env.get_observation()
        depth_pc = DepthPointCloud(depth, K, cam_pose, threshold=cfg["depth_threshold"], device=device)
        robot.setup_points_field(depth_pc.points)
        sdf = depth_pc.build_cost_field(robot.grid)
        ik_solver.setup_optimization(robot.grid)

        RT_grasps = load_grasps(data_dir, sim_name, object_name)
        pos, orn = env.get_object_pose(object_name)
        RT_obj = pose_from_position_quaternion(pos, [orn[3], orn[0], orn[1], orn[2]])
        RT_world = np.einsum("ij,njk->nik", RT_obj, RT_grasps)
        RT_base = RT_world.copy()
        RT_base[:, :3, 3] -= env.base_position

        q0 = torch.as_tensor(np.array(env.robot.q()), dtype=robot.dtype, device=device)
        start = clock(device)
        q_sols, err_pos, err_rot, _ = ik_solver.solve_ik_batch(
            q0, torch.as_tensor(RT_base, dtype=robot.dtype, device=device), sdf, env.base_position
        )
        found = ((err_pos < 0.01) & (err_rot < 5.0)).cpu().numpy()
        seconds = time.time() - start
        out[object_name] = (found, seconds)
        print(f"{object_name}: {found.sum()}/{found.size} grasps have IK ({seconds:.2f}s batched)")
    return out


if __name__ == "__main__":
    main()
