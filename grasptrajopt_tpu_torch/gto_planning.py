"""SceneReplica fixed-base grasp-planning driver, on the port.

Port of examples/gto_planning.py (the reference's
pybullet_gto_planning.py): per scene x ordering x object, the observation
-> two SDF cost fields on a grid over the scene cloud (with and without
the target object) -> the grasp-set collision pre-filter (the open
gripper's surface points at a 1 cm standoff against the obstacle cloud,
rejected above 1% inside) -> the multistart IK screen over the whole
grasp set (1 cm, 5 degrees, collision cost under the scene type's
threshold) -> the goal-set trajectory plan -> execute, close the gripper,
lift or back out, reward; the result file in the reference schema,
flushed after every scene.

On the card each field build and the pre-filter are one K1 launch each;
the fields stay on the card and go to the IK screen and the planner as
they are. The host reads what the driver decides on: the pre-filter's
inside mask, the IK screen's found mask and the plan it executes.

Robots: `synth7`, the synthetic arm with its gripper and
testing.SYNTH_SCENEREPLICA_CONFIG (Panda conventions; needs a tree written
by testing.make_scenereplica_tree as --assets_dir), or `panda` / `fetch`
from a robot data tree's configs/<robot>.yaml. Needs a `pybullet` module
(the real engine, or envs.fake_pybullet installed by the caller):

    python -m grasptrajopt_tpu_torch.gto_planning -r synth7 --assets_dir TREE -s 10

`--device cpu` runs float64 with the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time

import numpy as np
import torch

from grasptrajopt_tpu_torch.envs.camera import pose_from_position_quaternion
from grasptrajopt_tpu_torch.envs.grasps import load_grasps
from grasptrajopt_tpu_torch.fields.depth_point_cloud import DepthPointCloud
from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner
from grasptrajopt_tpu_torch.planning.ik_solver import IKSolver
from grasptrajopt_tpu_torch.planning.utils import get_data_dir
from grasptrajopt_tpu_torch.spatial import transform_points
from grasptrajopt_tpu_torch.testing import SYNTH_SCENEREPLICA_CONFIG
from grasptrajopt_tpu_torch.utils.cli import (
    asset_path,
    build_models,
    clock,
    require_pybullet,
    resolve_device,
    sim_robot_name,
)

SCENE_KNOBS = {
    "tabletop": dict(
        standoff_distance=-0.1, standoff_offset=-10, ik_collision_avoidance=False,
        ik_collision_threshold=5, interpolate=True, orderings=["nearest_first", "random"],
    ),
    "shelf": dict(
        standoff_distance=-0.2, standoff_offset=-10, ik_collision_avoidance=False,
        ik_collision_threshold=0.001, interpolate=False, orderings=["random"],
    ),
}

FILTER_OFFSET = -0.01  # the standoff at which the pre-filter places the gripper


def make_args(argv=None):
    parser = argparse.ArgumentParser(description="SceneReplica GTO planning on the port")
    parser.add_argument("-r", "--robot", default="panda", help="panda, fetch or synth7")
    parser.add_argument("-d", "--data_dir", default=None, help="SceneReplica dataset root")
    parser.add_argument("-s", "--scene_id", type=int, default=-1)
    parser.add_argument("-t", "--scene_type", default="tabletop")
    parser.add_argument("--assets_dir", default=None, help="robot/object asset tree")
    parser.add_argument("--goal_capacity", type=int, default=64)
    parser.add_argument(
        "--resume", default=None,
        help="partial result JSON to resume from (finished scenes are skipped)",
    )
    parser.add_argument("--outdir", default="results", help="where the result file goes")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default): float32 on the card, the kernels launched; "
                             "cpu: float64, the kernels' plain versions")
    return parser.parse_args(argv)


def filter_grasps_by_collision(gripper_model, gripper_open, RT_offs, depth_pc_obstacle):
    """Batched grasp collision pre-filter (the reference driver :202-240):
    the open gripper's surface points in its base frame, placed by every
    standoff pose (n, 4, 4) in one op, and one signed-distance query (one
    K1 launch) for all grasps. Returns host (keep (n,) bool, ratios (n,)
    of points inside)."""
    dev = depth_pc_obstacle.device
    pts_local = torch.as_tensor(
        gripper_model.compute_fk_surface_points(np.asarray(gripper_open)), dtype=torch.float32, device=dev
    )
    pts = transform_points(torch.as_tensor(np.asarray(RT_offs), dtype=torch.float32, device=dev), pts_local)
    n, P, _ = pts.shape
    inside = (depth_pc_obstacle.get_sdf(pts.reshape(-1, 3)) < 0).reshape(n, P).cpu().numpy()
    ratios = inside.mean(axis=1)
    return ratios <= 0.01, ratios


def main(argv=None):
    # parse first so `--help` works without the engine
    args = make_args(argv)
    require_pybullet()
    device = resolve_device(args.device)

    from grasptrajopt_tpu_torch.envs.scene_replica import SceneReplicaEnv

    robot_name = args.robot
    scene_type = args.scene_type
    knobs = SCENE_KNOBS[scene_type]
    assets_dir = args.assets_dir or get_data_dir()
    data_dir = args.data_dir or assets_dir

    robot, gripper_model, cfg = build_models(robot_name, assets_dir, device=device,
                                             synth_config=SYNTH_SCENEREPLICA_CONFIG)
    sim_name = sim_robot_name(robot_name, cfg)
    env = SceneReplicaEnv(asset_path(assets_dir, cfg, "urdf_robot_path"), data_dir, assets_dir, sim_name, scene_type)

    planner = GTOPlanner(
        robot, cfg["link_ee"], cfg["link_gripper"],
        standoff_distance=knobs["standoff_distance"],
        standoff_offset=knobs["standoff_offset"],
    )
    ik_solver = IKSolver(
        robot, cfg["link_ee"], cfg["link_gripper"],
        collision_avoidance=knobs["ik_collision_avoidance"],
    )

    total_success = 0
    count = 0
    results_scene = {}
    # checkpoint/resume at scene granularity: partial results are flushed
    # after every scene and can be reloaded with --resume
    os.makedirs(args.outdir, exist_ok=True)
    stamp = "{:%y-%m-%d_T%H%M%S}".format(datetime.datetime.now())
    out = os.path.join(args.outdir, f"GTO_scenereplica_{robot_name}_{scene_type}_{stamp}.json")
    if args.resume and os.path.exists(args.resume):
        with open(args.resume) as f:
            results_scene = json.load(f)
        print(f"resuming: {len(results_scene)} scenes already done")

    all_scene_ids = env.all_scene_ids if args.scene_id == -1 else [args.scene_id]
    for scene_id in all_scene_ids:
        if f"{scene_id}" in results_scene:
            continue
        print(f"===== Scene {scene_id} =====")
        meta = env.setup_scene(scene_id)

        results_ordering = {}
        for ordering in knobs["orderings"]:
            object_order = meta[ordering][0].split(",")
            results = {}
            set_objects = set(object_order)
            for object_name in object_order:
                count += 1
                env.reset_scene(set_objects)

                # perception: two SDF fields on a grid over the scene cloud
                rgba, depth, mask, cam_pose, K = env.get_observation()
                idx = env.object_uids[env.object_names.index(object_name)]
                target_mask = mask == idx
                start = clock(device)
                depth_pc = DepthPointCloud(depth, K, cam_pose, threshold=cfg["depth_threshold"], device=device)
                grid = robot.setup_points_field(depth_pc.points)
                sdf_cost_all = depth_pc.build_cost_field(grid)

                depth_obstacle = np.array(depth, copy=True)
                depth_obstacle[target_mask] = cfg["depth_threshold"]
                depth_pc_obstacle = DepthPointCloud(
                    depth_obstacle, K, cam_pose, target_mask, threshold=cfg["depth_threshold"], device=device
                )
                sdf_cost_obstacle = depth_pc_obstacle.build_cost_field(grid)
                field_time = clock(device) - start
                # the grid is this object's: the IK solver is built for it
                # again (the planner builds and keeps a solver a grid)
                start = clock(device)
                ik_solver.setup_optimization(grid)
                setup_time = clock(device) - start

                # grasp set -> world, batched collision pre-filter
                RT_grasps = load_grasps(data_dir, sim_name, object_name)
                pos, orn = env.get_object_pose(object_name)
                RT_obj = pose_from_position_quaternion(pos, [orn[3], orn[0], orn[1], orn[2]])
                start = clock(device)
                RT_grasps_world = np.einsum("ij,njk->nik", RT_obj, RT_grasps)
                RT_offs = RT_grasps_world @ robot.get_standoff_pose(FILTER_OFFSET, cfg["axis_standoff"])
                keep, ratios = filter_grasps_by_collision(
                    gripper_model, cfg["gripper_open_offsets"], RT_offs, depth_pc_obstacle
                )
                RT_grasps_world = RT_grasps_world[keep]
                checking_time = clock(device) - start
                print(f"{keep.size} grasps, {keep.sum()} collision-free ({checking_time:.2f}s; fields "
                      f"{field_time:.2f}s on {grid.size} cells, IK solver set up again in {setup_time:.3f}s)")
                if RT_grasps_world.shape[0] == 0:
                    set_objects.remove(object_name)
                    results[object_name] = {
                        "reward": 0, "plan": None, "checking_time": checking_time,
                        "ik_time": None, "planning_time": None,
                    }
                    continue

                # batched IK screen over the whole grasp set
                start = clock(device)
                RT_grasps_base = RT_grasps_world.copy()
                RT_grasps_base[:, :3, 3] -= env.base_position
                if scene_type == "shelf":
                    RT_ik = RT_grasps_base @ robot.get_standoff_pose(
                        knobs["standoff_distance"], cfg["axis_standoff"]
                    )
                else:
                    RT_ik = RT_grasps_base
                q0 = torch.as_tensor(np.array(env.robot.q()), dtype=robot.dtype, device=device)
                q_sols, err_pos, err_rot, col_cost = ik_solver.solve_ik_batch(
                    q0, torch.as_tensor(RT_ik, dtype=robot.dtype, device=device), sdf_cost_obstacle,
                    env.base_position, multistart=True,
                )
                found = ((err_pos < 0.01) & (err_rot < 5) & (col_cost < knobs["ik_collision_threshold"])).cpu().numpy()
                ik_time = clock(device) - start
                print(f"IK: {found.sum()}/{found.size} found ({ik_time:.2f}s)")
                RT_grasps_base = RT_grasps_base[found]
                # the found solutions stay on the device: (ndof, k)
                q_solutions = q_sols.index_select(0, torch.as_tensor(np.flatnonzero(found), device=device)).T
                if RT_grasps_base.shape[0] == 0:
                    set_objects.remove(object_name)
                    results[object_name] = {
                        "reward": 0, "plan": None, "checking_time": checking_time,
                        "ik_time": ik_time, "planning_time": None,
                    }
                    continue

                # goal-set trajectory optimization
                qc = np.array(env.robot.q())
                start = clock(device)
                cap = max(args.goal_capacity, RT_grasps_base.shape[0])
                plan, dQ, cost = planner.plan_goalset(
                    qc, RT_grasps_base, sdf_cost_all, sdf_cost_obstacle,
                    env.base_position, q_solutions,
                    use_standoff=True, axis_standoff=cfg["axis_standoff"],
                    interpolate=knobs["interpolate"], goal_capacity=cap,
                )
                planning_time = clock(device) - start
                print(f"planning time {planning_time:.2f}s cost {cost}")

                # execute
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
            results_ordering[ordering] = results
        results_scene[f"{scene_id}"] = results_ordering
        with open(out, "w") as f:  # flush checkpoint after every scene
            json.dump(results_scene, f)

    print("total success", total_success)
    with open(out, "w") as f:
        json.dump(results_scene, f)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
