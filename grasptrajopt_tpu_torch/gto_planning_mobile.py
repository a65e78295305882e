"""SceneReplica mobile-manipulation driver (base placement + arm planning),
on the port.

Port of examples/gto_planning_mobile.py (the reference's
pybullet_gto_planning_mobile.py): observe from afar -> the 2-D occupancy
grid (one K3 launch on the card, :157-162) -> 2 grasps drawn per object
-> BasePlanner until a collision-free base is found (:186-202) -> drive
the differential-drive base and turn it (:215-244) -> freeze the base
(mass 0, :244) -> the fixed-base driver's per-object loop in the base
frame with base_position = 0 (:246-430); the result file holds the chosen
base pose 'RT_base_new' (:247).

The robot drives its wheels and its head (the Fetch wrapper): the run
needs Fetch's data tree (`-r fetch --assets_dir DATA`) and a `pybullet`
module.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time

import numpy as np
import torch

from grasptrajopt_tpu_torch.envs.camera import pose_from_position_quaternion, rotZ
from grasptrajopt_tpu_torch.fields.depth_point_cloud import DepthPointCloud
from grasptrajopt_tpu_torch.gto_planning import FILTER_OFFSET, SCENE_KNOBS, filter_grasps_by_collision
from grasptrajopt_tpu_torch.planning.base_planner import BasePlanner
from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner
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
    parser = argparse.ArgumentParser(description="SceneReplica mobile GTO planning on the port")
    parser.add_argument("-r", "--robot", default="fetch")
    parser.add_argument("-d", "--data_dir", default=None)
    parser.add_argument("-s", "--scene_id", type=int, default=-1)
    parser.add_argument("-t", "--scene_type", default="tabletop")
    parser.add_argument("--assets_dir", default=None)
    parser.add_argument("--goal_capacity", type=int, default=64)
    parser.add_argument("--outdir", default="results", help="where the result file goes")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default): float32 on the card; cpu: float64, the plain kernels")
    return parser.parse_args(argv)


def robot_base_pose(env):
    pos, orn = env.get_robot_pose()
    return pose_from_position_quaternion(pos, [orn[3], orn[0], orn[1], orn[2]])


def main(argv=None):
    args = make_args(argv)
    require_pybullet()
    device = resolve_device(args.device)
    import pybullet as p

    from grasptrajopt_tpu_torch.envs.scene_replica import SceneReplicaEnv

    robot_name = args.robot
    scene_type = args.scene_type
    knobs = SCENE_KNOBS[scene_type]
    assets_dir = args.assets_dir or get_data_dir()
    data_dir = args.data_dir or assets_dir
    base_effort_weight = 0.01

    robot, gripper_model, cfg = build_models(robot_name, assets_dir, device=device,
                                             synth_config=SYNTH_SCENEREPLICA_CONFIG)
    env = SceneReplicaEnv(
        asset_path(assets_dir, cfg, "urdf_robot_path"), data_dir, assets_dir,
        sim_robot_name(robot_name, cfg), scene_type, mobile=True,
    )
    base_mass = p.getDynamicsInfo(env.robot._id, -1)[0]

    planner = GTOPlanner(
        robot, cfg["link_ee"], cfg["link_gripper"],
        standoff_distance=knobs["standoff_distance"],
        standoff_offset=knobs["standoff_offset"],
    )
    ik_solver = IKSolver(
        robot, cfg["link_ee"], cfg["link_gripper"],
        collision_avoidance=knobs["ik_collision_avoidance"],
    )
    base_planner = BasePlanner(robot, cfg["link_ee"], cfg["link_gripper"])

    total_success = 0
    count = 0
    results_scene = {}
    all_scene_ids = env.all_scene_ids if args.scene_id == -1 else [args.scene_id]
    for scene_id in all_scene_ids:
        results_ordering = {}
        for ordering in knobs["orderings"]:
            meta = env.setup_scene(scene_id)
            object_order = meta[ordering][0].split(",")

            # -- base placement phase ----------------------------------------
            RT_base = robot_base_pose(env)
            env.robot.look_at(pan=0, tilt=10)
            rgba, depth, mask, cam_pose, K = env.get_observation()
            cam_pose_b = np.linalg.inv(RT_base) @ cam_pose
            depth_pc = DepthPointCloud(depth, K, cam_pose_b, threshold=np.inf, device=device)
            robot.setup_occupancy_grid(depth_pc.points)

            # candidate grasps per object, in the robot base frame, dropping
            # grasps below the object (driver :166-184)
            RTs = {}
            for object_name in object_order:
                pos, orn = env.get_object_pose(object_name)
                RT_obj = pose_from_position_quaternion(pos, [orn[3], orn[0], orn[1], orn[2]])
                RT = np.linalg.inv(RT_base) @ RT_obj @ env.RT_grasps[object_name]
                RT_obj_base = np.linalg.inv(RT_base) @ RT_obj
                keep = RT[:, 2, 3] >= RT_obj_base[2, 3]
                RTs[object_name] = RT[keep]

            num = 2
            base_planner.setup_optimization(num * len(object_order), base_effort_weight)
            while True:
                grasps = [
                    RTs[o][np.random.choice(RTs[o].shape[0], num)]
                    for o in object_order
                    if RTs[o].shape[0] > 0
                ]
                RTs_all = np.concatenate(grasps)
                q0 = np.array(env.robot.q())
                plan_b, y, err_pos, err_rot, cost = base_planner.plan_goalset(
                    q0, RTs_all, verbose=False
                )
                if cost == 0:
                    break

            # y is "old base in new base"; invert to get the base motion
            RT_delta = rotZ(y[2])
            RT_delta[0, 3] = y[0]
            RT_delta[1, 3] = y[1]
            RT_base_delta = np.linalg.inv(RT_delta)
            RT_base_new = RT_base @ RT_base_delta

            env.robot.move_to_xy(RT_base_delta[0, 3], RT_base_delta[1, 3])
            RT_base = robot_base_pose(env)
            delta = np.linalg.inv(RT_base) @ RT_base_new
            yaw = np.arctan2(delta[1, 0], delta[0, 0])
            env.robot.move_to_theta(yaw)
            env.robot.look_at(pan=0, tilt=50)
            pos, orn = env.get_robot_pose()
            env.set_robot_pose(pos, orn)
            p.changeDynamics(env.robot._id, -1, mass=0)
            RT_base_new = robot_base_pose(env)

            # -- per-object loop (base frame, base_position = 0) --------------
            results = {"RT_base_new": RT_base_new.tolist()}
            set_objects = set(object_order)
            for object_name in object_order:
                count += 1
                env.reset_scene(set_objects)

                pos, orn = env.get_object_pose(object_name)
                RT_obj = pose_from_position_quaternion(pos, [orn[3], orn[0], orn[1], orn[2]])
                env.robot.look_at_point(RT_obj[:3, 3])

                rgba, depth, mask, cam_pose, K = env.get_observation()
                RT_base = robot_base_pose(env)
                cam_pose_b = np.linalg.inv(RT_base) @ cam_pose
                idx = env.object_uids[env.object_names.index(object_name)]
                target_mask = mask == idx
                depth = np.array(depth, copy=True)
                depth[mask == 1] = cfg["depth_threshold"]  # mask robot body

                depth_pc = DepthPointCloud(depth, K, cam_pose_b, threshold=cfg["depth_threshold"], device=device)
                grid = robot.setup_points_field(depth_pc.points)
                sdf_cost_all = depth_pc.build_cost_field(grid)
                depth_obstacle = np.array(depth, copy=True)
                depth_obstacle[target_mask] = cfg["depth_threshold"]
                depth_pc_obstacle = DepthPointCloud(
                    depth_obstacle, K, cam_pose_b, target_mask, threshold=cfg["depth_threshold"], device=device
                )
                sdf_cost_obstacle = depth_pc_obstacle.build_cost_field(grid)
                ik_solver.setup_optimization(grid)

                RT_grasps_base = np.linalg.inv(RT_base) @ RT_obj @ env.RT_grasps[object_name]
                start = clock(device)
                RT_offs = RT_grasps_base @ robot.get_standoff_pose(FILTER_OFFSET, cfg["axis_standoff"])
                keep, _ = filter_grasps_by_collision(
                    gripper_model, cfg["gripper_open_offsets"], RT_offs, depth_pc_obstacle
                )
                RT_grasps_base = RT_grasps_base[keep]
                checking_time = clock(device) - start
                if RT_grasps_base.shape[0] == 0:
                    set_objects.remove(object_name)
                    results[object_name] = {
                        "reward": 0, "plan": None, "checking_time": checking_time,
                        "ik_time": None, "planning_time": None,
                    }
                    continue

                start = clock(device)
                RT_ik = (
                    RT_grasps_base
                    @ robot.get_standoff_pose(knobs["standoff_distance"], cfg["axis_standoff"])
                    if scene_type == "shelf"
                    else RT_grasps_base
                )
                q0 = torch.as_tensor(np.array(env.robot.q()), dtype=robot.dtype, device=device)
                q_sols, err_pos, err_rot, col_cost = ik_solver.solve_ik_batch(
                    q0, torch.as_tensor(RT_ik, dtype=robot.dtype, device=device), sdf_cost_obstacle,
                    [0, 0, 0], multistart=True,
                )
                found = ((err_pos < 0.01) & (err_rot < 5) & (col_cost < knobs["ik_collision_threshold"])).cpu().numpy()
                ik_time = clock(device) - start
                RT_grasps_base = RT_grasps_base[found]
                q_solutions = q_sols.index_select(0, torch.as_tensor(np.flatnonzero(found), device=device)).T
                if RT_grasps_base.shape[0] == 0:
                    set_objects.remove(object_name)
                    results[object_name] = {
                        "reward": 0, "plan": None, "checking_time": checking_time,
                        "ik_time": ik_time, "planning_time": None,
                    }
                    continue

                qc = np.array(env.robot.q())
                start = clock(device)
                cap = max(args.goal_capacity, RT_grasps_base.shape[0])
                plan, dQ, cost = planner.plan_goalset(
                    qc, RT_grasps_base, sdf_cost_all, sdf_cost_obstacle, [0, 0, 0],
                    q_solutions, use_standoff=True, axis_standoff=cfg["axis_standoff"],
                    interpolate=knobs["interpolate"], goal_capacity=cap,
                )
                planning_time = clock(device) - start

                env.execute_plan(plan)
                env.robot.close_gripper()
                env.record_gripper_position()
                time.sleep(1.0)
                if scene_type == "tabletop":
                    env.retract(cfg["retract_distance"])
                else:
                    plan_standoff = plan[:, np.arange(knobs["standoff_offset"] - 10, -1)]
                    plan_reverse = plan_standoff[:, ::-1].copy()
                    plan_reverse[cfg["finger_index"], :] = 0
                    env.robot.execute_plan(plan_reverse)
                reward = env.compute_reward(object_name)
                env.reset_objects(object_name)
                env.robot.retract()
                set_objects.remove(object_name)
                total_success += reward
                print(f"scene {scene_id} {ordering} {object_name}: reward {reward} "
                      f"(total {total_success}/{count})")
                results[object_name] = {
                    "reward": reward, "plan": plan.tolist(), "checking_time": checking_time,
                    "ik_time": ik_time, "planning_time": planning_time,
                }

            # unfreeze base for the next ordering
            p.changeDynamics(env.robot._id, -1, mass=base_mass)
            results_ordering[ordering] = results
        results_scene[f"{scene_id}"] = results_ordering

    os.makedirs(args.outdir, exist_ok=True)
    stamp = "{:%y-%m-%d_T%H%M%S}".format(datetime.datetime.now())
    out = os.path.join(args.outdir, f"GTO_scenereplica_mobile_{robot_name}_{scene_type}_{stamp}.json")
    with open(out, "w") as f:
        json.dump(results_scene, f)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
