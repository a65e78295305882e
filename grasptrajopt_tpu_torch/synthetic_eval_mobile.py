"""Closed-loop MOBILE evaluation on synthetic scenes, on the port.

Port of examples/synthetic_eval_mobile.py. Per scene and ordering:
  1. observe the furniture from a base parked away from it (--start_pose)
     and build the 2-D occupancy grid in that base frame (one K3 launch
     on the card: GTORobotModel.setup_occupancy_grid);
  2. draw 2 grasps per object (numpy, seeded by the scene id), grasps
     below the object's centre dropped, and solve BasePlanner until the
     robot at its current configuration stands on no occupied cell (at
     most 10 tries);
  3. move the base there (the kinematic env has no wheels);
  4. run the fixed-base pipeline on every object in the NEW base frame
     with base_position = 0, scored by the replay scorer as in
     synthetic_eval.py; each ordering's record holds 'RT_base_new'.

Robots: `synth7` (the synthetic arm with its gripper, SYNTH_EVAL_CONFIG;
needs no data) or `fetch` from a robot data tree (GTO_DATA_DIR or
--data_dir); the JAX example takes fetch only. Fetch stands on the floor
(z = 0), as in the example. synth7 stands on the fixed-base harness's
mount, `env.base_position[2]` (0.7 m in the panda layout its config
names), so the table keeps its usual height relative to the arm. The
occupancy grid keeps only points more than 0.01 m above the base frame's
z = 0, so the mount decides what counts as occupied: at 0.7 m the table
top and what stands on it, not the floor.

The fields' grid resolution, which is also the occupancy grid's cell, is
the scene type's knob (SCENE_KNOBS: 5 cm tabletop, 2.5 cm shelf; the JAX
example builds 5 cm for both); the rest of the pipeline's configuration
is the example's (one view, no cloud dedup). On the card (the default;
float32):

    python -m grasptrajopt_tpu_torch.synthetic_eval_mobile -r synth7 -t tabletop \\
        --single_pass --coarse 2 --final_trust --iterations 3

On the CPU add `--device cpu` (float64, the plain kernel versions).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time

import numpy as np
import torch

from grasptrajopt_tpu_torch.envs.camera import rotZ
from grasptrajopt_tpu_torch.envs.render import look_at_pose
from grasptrajopt_tpu_torch.envs.synthetic import SyntheticSceneEnv
from grasptrajopt_tpu_torch.fields.depth_point_cloud import DepthPointCloud
from grasptrajopt_tpu_torch.planning import evaluate
from grasptrajopt_tpu_torch.planning.base_planner import BasePlanner
from grasptrajopt_tpu_torch.planning.pipeline import GraspPipeline
from grasptrajopt_tpu_torch.planning.utils import default_pose
from grasptrajopt_tpu_torch.synthetic_eval import SCENE_KNOBS, summary
from grasptrajopt_tpu_torch.utils.cli import build_models, resolve_device


def make_args(argv=None):
    p = argparse.ArgumentParser(description="synthetic mobile closed-loop evaluation on the port")
    p.add_argument("-r", "--robot", default="fetch", choices=["fetch", "synth7"])
    p.add_argument("-t", "--scene_type", default="tabletop", choices=["tabletop", "shelf"])
    p.add_argument("--scene_ids", default="10,36")
    p.add_argument("--n_objects", type=int, default=5)
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--height", type=int, default=160)
    p.add_argument("--goal_capacity", type=int, default=32)
    p.add_argument("--iterations", type=int, default=50)
    p.add_argument("--single_pass", action="store_true",
                   help="delayed-gratification LM (the bench default flavor)")
    p.add_argument("--coarse", type=int, default=0,
                   help="coarse-fidelity obstacle iterations (requires --single_pass)")
    p.add_argument("--coarse_stride", type=int, default=2,
                   help="surface-point stride of the coarse phase")
    p.add_argument("--final_trust", action="store_true",
                   help="return the final KKT trial unevaluated (requires --single_pass)")
    p.add_argument("--start_pose", default="-0.8,0.3,-0.3", help="x,y,yaw parked base")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default): float32 on the card, the kernels launched; "
                        "cpu: float64, the kernels' plain versions")
    p.add_argument("--outdir", default="results")
    p.add_argument("--data_dir", default=None)
    return p.parse_args(argv)


def base_pose_matrix(x: float, y: float, yaw: float) -> np.ndarray:
    RT = rotZ(yaw)
    RT[0, 3] = x
    RT[1, 3] = y
    return RT


def mount_height(robot, env) -> float:
    """The base frame's height above the floor: the fixed-base harness's
    mount for synth7, the floor for any other robot (module docstring)."""
    return float(env.base_position[2]) if robot.name == "synth7" else 0.0


def head_camera_pose(RT_base: np.ndarray, target_world) -> np.ndarray:
    """World pose of a head-height camera on the base looking at a world
    target."""
    eye = RT_base[:3, 3] + RT_base[:3, :3] @ np.array([0.12, 0.0, 1.05])
    return look_at_pose(eye, np.asarray(target_world, np.float64))


def plan_base_placement(env, robot, base_planner, RT_base, meta, order, rng,
                        base_effort_weight=0.01, num=2, max_tries=10):
    """Occupancy grid from afar, then BasePlanner on `num` grasps drawn
    per object until the robot's occupancy cost is 0 (at most `max_tries`).

    Returns (RT_base_new (4, 4) world, y (3,) the old base in the new
    base frame, tries: one dict per try with its col_cost, base pose y
    and the chosen grasps' err_pos / err_rot)."""
    if env.scene_type == "tabletop":
        target = env.TABLE_POS + [0.0, 0.0, env.TABLE_HEIGHT]
    else:
        target = env.SHELF_POS
    cam_pose_w = head_camera_pose(RT_base, target)
    depth, mask, cam_pose_w, K = env.get_observation(cam_pose_w)
    cam_pose_b = np.linalg.inv(RT_base) @ cam_pose_w
    depth_pc = DepthPointCloud(depth, K, cam_pose_b, threshold=np.inf, device=robot.device)
    robot.setup_occupancy_grid(depth_pc.points)

    # candidate grasps per object in the base frame; those below the
    # object's centre dropped (unless none is left)
    RTs = {}
    for name in order:
        RT_w = env.grasps_world(name)
        RT_b = np.linalg.inv(RT_base)[None] @ RT_w
        obj_z_b = (np.linalg.inv(RT_base) @ env._placed(name).pose)[2, 3]
        keep = RT_b[:, 2, 3] >= obj_z_b
        RTs[name] = RT_b[keep] if keep.any() else RT_b

    base_planner.setup_optimization(num * len(order), base_effort_weight)
    y, tries = None, []
    for _ in range(max_tries):
        RTs_all = np.concatenate(
            [RTs[o][rng.choice(RTs[o].shape[0], num)] for o in order]
        )
        qc = default_pose(robot)
        _, y, err_pos, err_rot, col_cost = base_planner.plan_goalset(qc, RTs_all, verbose=False)
        tries.append({"col_cost": col_cost, "y": y.tolist(), "err_pos": err_pos.tolist(),
                      "err_rot": err_rot.tolist()})
        if col_cost == 0:
            break
    # y is the old base in the new base frame: invert it for the motion
    RT_delta = base_pose_matrix(y[0], y[1], y[2])
    return RT_base @ np.linalg.inv(RT_delta), y, tries


def make_pipeline(robot, gripper, cfg, scene_type: str, goal_capacity: int = 32, iterations: int = 50,
                  single_pass: bool = False, coarse_iterations: int = 0, coarse_stride: int = 2,
                  final_trust: bool = False) -> GraspPipeline:
    """The example's pipeline: the scene type's standoff, goal weight and
    warm start, one view, the robot's grid."""
    knobs = SCENE_KNOBS[scene_type]
    return GraspPipeline(
        robot, gripper, cfg["link_ee"], cfg["link_gripper"],
        axis_standoff=cfg["axis_standoff"],
        gripper_open_offsets=cfg["gripper_open_offsets"],
        standoff_distance=knobs["standoff_distance"],
        goal_capacity=goal_capacity, grid=robot.grid,
        ik_capacity=goal_capacity, planner_iterations=iterations,
        planner_single_pass=single_pass,
        planner_coarse_iterations=coarse_iterations,
        planner_coarse_stride=coarse_stride,
        planner_final_trust=final_trust,
        goal_weight=knobs.get("goal_weight", {}).get(cfg["robot_name"], 1.0),
        interpolate=knobs.get("interpolate", True),
    )


def run_object(env, robot, pipeline, cfg, name, RT_base_new, goal_capacity: int) -> dict:
    """One object's trial in the base frame RT_base_new (world, 4 x 4):
    observe it from the head camera, plan with base_position = 0, score
    the plan. Returns the object's record."""
    RT_base_inv = np.linalg.inv(RT_base_new)
    obj_pos_w = env._placed(name).pose[:3, 3]
    cam_pose_w = head_camera_pose(RT_base_new, obj_pos_w)
    depth, mask, _, K = env.get_observation(cam_pose_w)
    cam_pose_b = RT_base_inv @ cam_pose_w
    target_mask = mask == env._placed(name).uid
    RTs_b = RT_base_inv[None] @ env.grasps_world(name, capacity=goal_capacity)
    qc = np.asarray(cfg["default_pose"])
    res = pipeline.plan_object(qc, depth, K, cam_pose_b, target_mask, RTs_b, np.zeros(3))
    rec = {
        "reward": 0,
        "checking_time": res.checking_time,
        "ik_time": res.ik_time,
        "planning_time": res.planning_time,
        "stage": res.stage,
        "num_grasps": res.n_grasps,
        "num_collision_free": res.n_collision_free,
        "num_ik": res.n_ik_found,
        "rescued": res.rescued,
        "escalated": res.escalated,
    }
    if res.plan is not None:
        depth_obs = np.array(depth, copy=True)
        depth_obs[target_mask] = pipeline.depth_threshold
        dpc_obs = DepthPointCloud(
            depth_obs, K, cam_pose_b, target_mask, threshold=pipeline.depth_threshold, device=robot.device,
        )
        rec.update(evaluate.score_plan(robot, cfg["link_ee"], res.plan, RTs_b, dpc_obs, np.zeros(3)))
        rec["plan"] = res.plan.tolist()
    return rec


def evaluate_scenes(
    robot,
    gripper,
    cfg,
    scene_type: str = "tabletop",
    scene_ids=(10,),
    n_objects: int = 5,
    width: int = 160,
    height: int = 160,
    goal_capacity: int = 32,
    iterations: int = 50,
    single_pass: bool = False,
    coarse_iterations: int = 0,
    coarse_stride: int = 2,
    final_trust: bool = False,
    start_pose=(-0.8, 0.3, -0.3),
    orderings=None,
    verbose: bool = True,
    placements: list = None,
):
    """Place the base, then run every object of each scene and ordering
    in the new base frame; returns the result dict (the reference schema,
    'RT_base_new' per ordering). `placements`, when given, gets one dict
    per ordering: scene, ordering, RT_base_new, y and the tries."""
    knobs = SCENE_KNOBS[scene_type]
    orderings = orderings or knobs["orderings"]
    env = SyntheticSceneEnv(
        robot_name=cfg["robot_name"], scene_type=scene_type,
        n_objects=n_objects, width=width, height=height,
        depth_threshold=cfg.get("depth_threshold", 1.5),
    )
    pipeline = make_pipeline(robot, gripper, cfg, scene_type, goal_capacity, iterations, single_pass,
                             coarse_iterations, coarse_stride, final_trust)
    base_planner = BasePlanner(robot, cfg["link_ee"], cfg["link_gripper"])
    x0, y0, yaw0 = start_pose
    results = {}
    for scene_id in scene_ids:
        meta = env.setup_scene(scene_id)
        rng = np.random.default_rng(scene_id)
        scene_rec = {}
        for ordering in orderings:
            env.reset_scene()
            order = meta[ordering].split(",")
            RT_base0 = base_pose_matrix(x0, y0, yaw0)
            RT_base0[2, 3] = mount_height(robot, env)
            RT_base_new, y, tries = plan_base_placement(env, robot, base_planner, RT_base0, meta, order, rng)
            if placements is not None:
                placements.append({"scene": scene_id, "ordering": ordering, "RT_base_new": RT_base_new,
                                   "y": y, "tries": tries})
            if verbose:
                print(
                    f"scene {scene_id} [{ordering}] base: "
                    f"({RT_base_new[0, 3]:.2f}, {RT_base_new[1, 3]:.2f}, "
                    f"yaw {np.arctan2(RT_base_new[1, 0], RT_base_new[0, 0]):.2f}) after {len(tries)} "
                    f"tries, col_cost {[t['col_cost'] for t in tries]}",
                    flush=True,
                )
            order_rec = {"RT_base_new": RT_base_new.tolist()}
            for name in order:
                rec = run_object(env, robot, pipeline, cfg, name, RT_base_new, goal_capacity)
                order_rec[name] = rec
                env.remove_object(name)
                if verbose:
                    print(
                        f"scene {scene_id} [{ordering}] {name}: stage={rec['stage']} "
                        f"reward={rec.get('reward', 0)} "
                        f"err_pos={rec.get('err_pos', float('nan')):.3f} "
                        f"collision={rec.get('collision', '-')} "
                        f"t={rec['checking_time'] + rec['ik_time'] + rec['planning_time']:.1f}s",
                        flush=True,
                    )
            scene_rec[ordering] = order_rec
        results[str(scene_id)] = scene_rec
    return results


def main(argv=None):
    args = make_args(argv)
    device = resolve_device(args.device)
    robot, gripper, cfg = build_models(args.robot, args.data_dir, device=device,
                                       grid_resolution=SCENE_KNOBS[args.scene_type]["grid_resolution"])
    scene_ids = [int(s) for s in args.scene_ids.split(",")]
    start_pose = tuple(float(v) for v in args.start_pose.split(","))

    t0 = time.time()
    results = evaluate_scenes(
        robot, gripper, cfg,
        scene_type=args.scene_type, scene_ids=scene_ids,
        n_objects=args.n_objects, width=args.width, height=args.height,
        goal_capacity=args.goal_capacity, iterations=args.iterations,
        single_pass=args.single_pass, coarse_iterations=args.coarse,
        coarse_stride=args.coarse_stride, final_trust=args.final_trust,
        start_pose=start_pose,
    )
    elapsed = time.time() - t0
    os.makedirs(args.outdir, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%y-%m-%d_T%H%M%S")
    out = os.path.join(args.outdir, f"GTO_synthetic_mobile_{args.robot}_{args.scene_type}_{stamp}.json")
    with open(out, "w") as f:
        json.dump(results, f)
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps({
        **summary(results), "elapsed_s": round(elapsed, 1), "device": device_name,
        "results_file": out,
    }))


if __name__ == "__main__":
    main()
