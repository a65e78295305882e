"""Closed-loop evaluation on synthetic tabletop and shelf scenes, on the port.

Port of examples/synthetic_eval.py: procedurally generated scenes
(envs/synthetic.py), depth observations from the numpy renderer, the full
GraspPipeline per object (fields -> grasp filter -> IK screen -> goal-set
plan -> rescue / escalation / safe-decline), then the replay scorer's
verdict: goal reach within the gates and step-wise collision (more than 5
body points with sdf < 0 is a collision). Writes the reference result
schema, which utils/results.py aggregates.

Robots: `synth7`, the synthetic arm with its gripper (SYNTH_EVAL_CONFIG;
needs no data), or `panda` / `fetch` from a robot data tree (GTO_DATA_DIR
or --data_dir). On the card (the default; float32):

    python -m grasptrajopt_tpu_torch.synthetic_eval -r synth7 -t tabletop \\
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

from grasptrajopt_tpu_torch.envs.synthetic import SyntheticSceneEnv
from grasptrajopt_tpu_torch.fields.depth_point_cloud import DepthPointCloud, FusedDepthPointCloud
from grasptrajopt_tpu_torch.planning import evaluate
from grasptrajopt_tpu_torch.planning.pipeline import GraspPipeline
from grasptrajopt_tpu_torch.utils.cli import build_models, resolve_device
from grasptrajopt_tpu_torch.utils.results import aggregate_results

# scene-type knobs, as in the JAX harness: the shelf's deep standoff with
# a 4x goal weight (panda), the constant-qc warm start, a 2.5 cm grid with
# a 1 cm dedup of the dense builds' cloud, and two fused views of which
# the planner's fields use the first
SCENE_KNOBS = {
    "tabletop": dict(
        standoff_distance=-0.1, orderings=["nearest_first", "random"],
        goal_weight={}, interpolate=True,
        grid_resolution=0.05, field_epsilon=0.02,
    ),
    "shelf": dict(
        standoff_distance=-0.2, orderings=["random"],
        goal_weight={"panda": 4.0}, interpolate=False,
        grid_resolution=0.025, field_epsilon=0.02, field_downsample=0.01,
        views=2, plan_views=1,
    ),
}


def make_args(argv=None):
    p = argparse.ArgumentParser(description="synthetic closed-loop evaluation on the port")
    p.add_argument("-r", "--robot", default="panda", choices=["panda", "fetch", "synth7"])
    p.add_argument("-t", "--scene_type", default="tabletop", choices=["tabletop", "shelf"])
    p.add_argument("--scene_ids", default="10,36,48,65,77")
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
    p.add_argument("--resume", default=None,
                   help="path to a (partial) result JSON from an interrupted run; completed "
                        "objects are skipped and new results are checkpointed into the SAME "
                        "file. The solver flavor flags must match the original run.")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default): float32 on the card, the kernels launched; "
                        "cpu: float64, the kernels' plain versions")
    p.add_argument("--outdir", default="results")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--grid_resolution", type=float, default=None,
                   help="override the scene-type knob (m/voxel)")
    p.add_argument("--field_epsilon", type=float, default=None,
                   help="override the scene-type cost-band knob (m)")
    p.add_argument("--views", type=int, default=None,
                   help="number of fused camera views (default: scene knob)")
    return p.parse_args(argv)


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
    orderings=None,
    verbose: bool = True,
    field_epsilon: float = None,
    views: int = None,
    checkpoint_path: str = None,
    prior: dict = None,
):
    """Run the pipeline over synthetic scenes; returns the result dict in
    the reference schema with the scorer's fields per object.

    The caller owns the grid (build the robot's workspace field at
    SCENE_KNOBS[scene_type]['grid_resolution']). checkpoint_path: the
    partial result is re-dumped there atomically after every object.
    prior: a partial result of an interrupted run with the same flavour;
    its objects are skipped (still removed from the scene, so later
    objects see the same scene state)."""
    knobs = SCENE_KNOBS[scene_type]
    orderings = orderings or knobs["orderings"]
    if field_epsilon is None:
        field_epsilon = knobs.get("field_epsilon", 0.02)
    if views is None:
        views = knobs.get("views", 1)
    env = SyntheticSceneEnv(
        robot_name=cfg["robot_name"], scene_type=scene_type,
        n_objects=n_objects, width=width, height=height,
        depth_threshold=cfg.get("depth_threshold", 1.5),
    )
    pipeline = GraspPipeline(
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
        field_epsilon=field_epsilon,
        field_downsample=knobs.get("field_downsample"),
        plan_views=knobs.get("plan_views"),
    )
    qc = np.asarray(cfg["default_pose"])
    base_position = env.base_position

    results = {}
    for scene_id in scene_ids:
        meta = env.setup_scene(scene_id)
        scene_rec = {}
        for ordering in orderings:
            env.reset_scene()
            order_rec = {}
            for name in meta[ordering].split(","):
                prev = (prior or {}).get(str(scene_id), {}).get(ordering, {}).get(name)
                if prev is not None and "reward" in prev:
                    order_rec[name] = prev
                    env.remove_object(name)
                    if verbose:
                        print(f"scene {scene_id} [{ordering}] {name}: resumed "
                              f"(reward={prev.get('reward', 0)})", flush=True)
                    continue
                cam_poses = env.camera_poses(views)
                uid = env._placed(name).uid
                depths, masks = [], []
                for cp in cam_poses:
                    d, m, _, K = env.get_observation(cp)
                    depths.append(d)
                    masks.append(m == uid)
                RTs = env.grasps_world(name, capacity=goal_capacity)
                res = pipeline.plan_object(
                    qc,
                    depths if views > 1 else depths[0],
                    K,
                    cam_poses if views > 1 else cam_poses[0],
                    masks if views > 1 else masks[0],
                    RTs,
                    base_position,
                )
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
                    obs_views = []
                    for d, cp, m in zip(depths, cam_poses, masks):
                        d_obs = np.array(d, copy=True)
                        d_obs[m] = pipeline.depth_threshold
                        obs_views.append(DepthPointCloud(
                            d_obs, K, cp, m, threshold=pipeline.depth_threshold, device=robot.device,
                        ))
                    dpc_obs = obs_views[0] if len(obs_views) == 1 else FusedDepthPointCloud(obs_views)
                    RT_base = RTs.copy()
                    RT_base[:, :3, 3] -= base_position
                    rec.update(evaluate.score_plan(
                        robot, cfg["link_ee"], res.plan, RT_base, dpc_obs, base_position
                    ))
                    rec["plan"] = res.plan.tolist()
                order_rec[name] = rec
                if checkpoint_path is not None:
                    snapshot = dict(results)
                    snapshot[str(scene_id)] = {**scene_rec, ordering: order_rec}
                    # atomic: never leave a truncated checkpoint behind
                    with open(checkpoint_path + ".tmp", "w") as f:
                        json.dump(snapshot, f)
                    os.replace(checkpoint_path + ".tmp", checkpoint_path)
                env.remove_object(name)
                if verbose:
                    print(
                        f"scene {scene_id} [{ordering}] {name}: stage={res.stage} "
                        f"reward={rec.get('reward', 0)} "
                        f"err_pos={rec.get('err_pos', float('nan')):.3f} "
                        f"collision={rec.get('collision', '-')} "
                        f"t={res.checking_time + res.ik_time + res.planning_time:.1f}s",
                        flush=True,
                    )
            scene_rec[ordering] = order_rec
        results[str(scene_id)] = scene_rec
    return results


def summary(results: dict) -> dict:
    """The aggregate the harness prints: trials, successes, collisions and
    the mean stage times (entries that are no object record, such as the
    mobile harness's 'RT_base_new', are skipped)."""
    agg = aggregate_results(results)
    collisions = sum(
        int(bool(rec.get("collision", False)))
        for orderings in results.values()
        for obj in orderings.values()
        for rec in obj.values()
        if isinstance(rec, dict)
    )
    return {
        "trials": agg["trials"],
        "success": agg["success"],
        "success_rate": round(agg["success_rate"], 3),
        "collisions": collisions,
        "mean_checking_time": round(agg["mean_checking_time"] or 0, 2),
        "mean_ik_time": round(agg["mean_ik_time"] or 0, 2),
        "mean_planning_time": round(agg["mean_planning_time"] or 0, 2),
    }


def main(argv=None):
    args = make_args(argv)
    device = resolve_device(args.device)
    knobs = SCENE_KNOBS[args.scene_type]
    grid_resolution = args.grid_resolution if args.grid_resolution is not None else knobs["grid_resolution"]
    robot, gripper, cfg = build_models(
        args.robot, args.data_dir, grid_resolution=grid_resolution, device=device
    )
    scene_ids = [int(s) for s in args.scene_ids.split(",")]

    os.makedirs(args.outdir, exist_ok=True)
    prior = None
    if args.resume:
        with open(args.resume) as f:
            prior = json.load(f)
        out = args.resume
        n_prior = sum(len(objs) for ords in prior.values() for objs in ords.values())
        print(f"resuming {args.resume}: {n_prior} objects already recorded", flush=True)
    else:
        stamp = datetime.datetime.now().strftime("%y-%m-%d_T%H%M%S")
        views_n = args.views or knobs.get("views", 1)
        tag = f"_mv{views_n}" if views_n > 1 else ""
        out = os.path.join(args.outdir, f"GTO_synthetic_{args.robot}_{args.scene_type}{tag}_{stamp}.json")

    t0 = time.time()
    results = evaluate_scenes(
        robot, gripper, cfg,
        scene_type=args.scene_type, scene_ids=scene_ids,
        n_objects=args.n_objects, width=args.width, height=args.height,
        goal_capacity=args.goal_capacity, iterations=args.iterations,
        single_pass=args.single_pass, coarse_iterations=args.coarse,
        coarse_stride=args.coarse_stride, final_trust=args.final_trust,
        field_epsilon=args.field_epsilon, views=args.views,
        checkpoint_path=out, prior=prior,
    )
    elapsed = time.time() - t0
    with open(out + ".tmp", "w") as f:
        json.dump(results, f)
    os.replace(out + ".tmp", out)
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps({
        **summary(results), "elapsed_s": round(elapsed, 1), "device": device_name, "results_file": out,
    }))


if __name__ == "__main__":
    main()
