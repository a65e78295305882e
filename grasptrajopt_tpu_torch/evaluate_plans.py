"""Replay recorded plans in the simulator and re-check collisions and
success, on the port.

Port of examples/evaluate_plans.py (the reference's
pybullet_evaluate_plans.py): per object the depth is rendered again with
the target masked to 2.0 m (:199), the obstacle cloud rebuilt, every plan
step's body surface points FK'd, and a collision flagged where a step has
more than 5 points with sdf < 0 (:219-237). The aggregation is
utils/results.py's, which also runs without a simulator.

Each plan's check is one FK of all its steps and one signed-distance query
(one K1 launch on the card); the host reads the verdict.

    python -m grasptrajopt_tpu_torch.evaluate_plans -r synth7 --assets_dir TREE -s 10 -f RESULT.json
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from grasptrajopt_tpu_torch.envs.camera import pose_from_position_quaternion
from grasptrajopt_tpu_torch.fields.depth_point_cloud import DepthPointCloud
from grasptrajopt_tpu_torch.planning.utils import get_data_dir
from grasptrajopt_tpu_torch.testing import SYNTH_SCENEREPLICA_CONFIG
from grasptrajopt_tpu_torch.utils.cli import asset_path, build_models, resolve_device, sim_robot_name
from grasptrajopt_tpu_torch.utils.results import aggregate_results, load_results


def make_args(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate recorded plans on the port")
    parser.add_argument("-r", "--robot", default="panda", help="panda, fetch or synth7")
    parser.add_argument("-d", "--data_dir", default=None)
    parser.add_argument("-s", "--scene_id", type=int, default=-1)
    parser.add_argument("-t", "--scene_type", default="tabletop")
    parser.add_argument("-f", "--file", required=True)
    parser.add_argument("--mobile", action="store_true")
    parser.add_argument("--assets_dir", default=None)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default): float32 on the card; cpu: float64, the plain kernels")
    return parser.parse_args(argv)


def check_plan_collision(robot, plan, depth_pc, base_position):
    """True if any step of the (ndof, T) plan puts more than 5 body points
    inside the scene (the reference :219-237), all steps in one batch."""
    Q = torch.as_tensor(np.asarray(plan).T, dtype=robot.dtype, device=robot.device)  # (T, ndof)
    pts = robot.fk_surface_points(Q, base_position=torch.as_tensor(
        np.asarray(base_position), dtype=robot.dtype, device=robot.device))
    T, P, _ = pts.shape
    inside = (depth_pc.get_sdf(pts.reshape(-1, 3)) < 0).reshape(T, P)
    return bool((inside.sum(dim=1) > 5).any())


def main(argv=None):
    """Replays the file's plans and returns the aggregate (with the
    collision counts), or the recorded-success aggregate alone where no
    `pybullet` module is importable."""
    args = make_args(argv)
    try:
        import pybullet as p
    except ImportError:
        p = None
    assets_dir = args.assets_dir or get_data_dir()
    data_dir = args.data_dir or assets_dir

    results_scene = load_results(args.file)
    if p is None:
        print("pybullet not available: reporting recorded-success aggregation only")
        agg = aggregate_results(results_scene)
        print(agg)
        return agg
    device = resolve_device(args.device)

    from grasptrajopt_tpu_torch.envs.scene_replica import SceneReplicaEnv
    from grasptrajopt_tpu_torch.spatial import r2quat

    scene_type = args.scene_type
    orderings = ["nearest_first", "random"] if scene_type == "tabletop" else ["random"]
    robot, _, cfg = build_models(args.robot, assets_dir, device=device, synth_config=SYNTH_SCENEREPLICA_CONFIG)
    env = SceneReplicaEnv(
        asset_path(assets_dir, cfg, "urdf_robot_path"), data_dir, assets_dir,
        sim_robot_name(args.robot, cfg), scene_type, mobile=args.mobile,
    )
    base_mass = p.getDynamicsInfo(env.robot._id, -1)[0]

    total_collision = 0
    collision_by_object = {}
    all_scene_ids = env.all_scene_ids if args.scene_id == -1 else [args.scene_id]
    for scene_id in all_scene_ids:
        meta = env.setup_scene(scene_id)
        results_ordering = results_scene[f"{scene_id}"]
        for ordering in orderings:
            object_order = meta[ordering][0].split(",")
            results = results_ordering[ordering]
            if args.mobile:
                RT_base_new = np.array(results["RT_base_new"]).reshape(4, 4)
                q = r2quat(torch.as_tensor(RT_base_new[:3, :3], dtype=torch.float64)).numpy()
                env.set_robot_pose(RT_base_new[:3, 3], q.tolist())
                p.changeDynamics(env.robot._id, -1, mass=0)
            set_objects = set(object_order)
            for object_name in object_order:
                rec = results[object_name]
                env.reset_scene(set_objects)
                rgba, depth, mask, cam_pose, K = env.get_observation()
                idx = env.object_uids[env.object_names.index(object_name)]
                target_mask = mask == idx
                depth = np.array(depth, copy=True)
                depth[target_mask] = 2.0
                if args.mobile:
                    depth[mask == 1] = 2.0
                    pos, orn = env.get_robot_pose()
                    RT_base = pose_from_position_quaternion(pos, [orn[3], orn[0], orn[1], orn[2]])
                    cam_pose = np.linalg.inv(RT_base) @ cam_pose
                depth_pc = DepthPointCloud(
                    depth, K, cam_pose, target_mask, threshold=cfg["depth_threshold"], device=device
                )
                in_collision = False
                if rec["plan"] is not None:
                    base = [0, 0, 0] if args.mobile else env.base_position
                    in_collision = check_plan_collision(robot, rec["plan"], depth_pc, base)
                total_collision += int(in_collision)
                collision_by_object[object_name] = (
                    collision_by_object.get(object_name, 0) + int(in_collision)
                )
                print(f"{object_name}: success {rec['reward']}, collision {int(in_collision)}")
                set_objects.remove(object_name)
                env.reset_objects(object_name)
            if args.mobile:
                p.changeDynamics(env.robot._id, -1, mass=base_mass)

    agg = aggregate_results(results_scene)
    agg["total_collision"] = total_collision
    agg["collision_by_object"] = collision_by_object
    print(agg)
    return agg


if __name__ == "__main__":
    main()
