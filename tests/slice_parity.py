"""The perception-to-plan slice at a tiny size, through the port
(`grasptrajopt_tpu_torch.e2e.PerceptionToPlan`) and through the JAX
package's library calls in the same order (bench_e2e.py's fields -> IK ->
plan chain), float64 on the CPU.

Two objects of scene 36 at 48x48, the synthetic arm with 10 points per
link on a 10 cm workspace grid (the 5 cm grid's field build is too slow
for a CPU test), 8 goals per object, IK 10 iterations, plan 3 iterations
with the coarse 2+1 schedule and final_trust.
"""

from __future__ import annotations

import numpy as np
import torch

import jax.numpy as jnp

from grasptrajopt_tpu.fields import depth_point_cloud as jdpc
from grasptrajopt_tpu.planning.gto_planner import GTOPlanner as JaxPlanner
from grasptrajopt_tpu.planning.ik_solver import IKSolver as JaxIK
from grasptrajopt_tpu.planning.utils import interpolate_waypoints_jnp
from grasptrajopt_tpu.spatial import transform_points as jax_tp
from grasptrajopt_tpu.testing import SYNTH_DEFAULT_POSE
from grasptrajopt_tpu_torch.e2e import PerceptionToPlan, SliceConfig, collect_observations
from grasptrajopt_tpu_torch.ops import nn as pnn
from grasptrajopt_tpu_torch.testing import SYNTH_EVAL_CONFIG, make_synthetic_gripper
from torch_parity import make_jax_synth_gripper, make_jax_synth_robot, np_, port_robot

CFG = SliceConfig(
    batch=2, goal_capacity=8, width=48, height=48, scenes=(36,),
    ik_iterations=10, plan_iterations=3, coarse_iterations=2, final_trust=True,
)
QC = SYNTH_DEFAULT_POSE.astype(np.float64)


def run_port():
    """(JAX robot, observations, the port's slice outputs as numpy)."""
    jr = make_jax_synth_robot(points_per_link=10, grid_resolution=0.1)
    obs = collect_observations(CFG)
    before = pnn.min_d2_launches
    gripper = make_synthetic_gripper(device="cpu", dtype=torch.float64, points_per_link=10)
    out = PerceptionToPlan(port_robot(jr), gripper, CFG).run(obs)
    assert pnn.min_d2_launches == before  # CPU tensors take the plain K1
    port = {k: np_(out[k]) for k in ("keep", "found", "goal_mask", "X0", "Q", "cost")}
    port["f_all"], port["f_obs"] = np_(out["fields"].f_all), np_(out["fields"].f_obs)
    return jr, obs, port


def base_frame_goals(obs):
    tf_goal = obs.grasps_world.copy()
    tf_goal[..., :3, 3] -= obs.base_position
    return tf_goal


def jax_upstream(jr, obs):
    """Fields, grasp pre-filter, IK screen, warm start and goal mask through
    the JAX package, one object at a time."""
    cfg = CFG
    B, G = obs.grasps_world.shape[:2]
    K = jnp.asarray(obs.K, jnp.float64)
    grid_pts = jnp.asarray(jr.grid.grid_points(np.float64))
    # the JAX gripper model's points at the open finger offsets
    # (bench_e2e.py's pre-filter), built from the same URDF string
    gripper_pts, _ = make_jax_synth_gripper(10).compute_fk_surface_points(
        np.asarray(SYNTH_EVAL_CONFIG["gripper_open_offsets"])
    )
    gripper_pts = jnp.asarray(gripper_pts)
    filter_off = np.eye(4)
    filter_off[2, 3] = cfg.filter_standoff
    f_all, f_obs, keep = [], [], []
    for b in range(B):
        depth = jnp.asarray(obs.depth[b], jnp.float64)
        mask = jnp.asarray(obs.target_mask[b])
        pose = jnp.asarray(obs.cam_pose[b], jnp.float64)
        fa, fo, op, om = jdpc.build_two_cost_fields(
            depth, K, pose, mask, grid_pts, threshold=cfg.depth_threshold,
            epsilon=cfg.field_epsilon, dedup_voxel=cfg.dedup_voxel,
            capacity_obstacle=cfg.capacity_obstacle, capacity_target=cfg.capacity_target,
        )
        gp = jax_tp(jnp.asarray(obs.grasps_world[b]) @ filter_off, gripper_pts)
        d_obs_img = jnp.where(mask, cfg.depth_threshold, depth)
        sdf = jdpc.signed_distance_to_cloud(gp.reshape(-1, 3), op, om, d_obs_img, K, pose)
        keep.append(np.asarray((sdf.reshape(G, -1) < 0).mean(axis=1) <= 0.01))
        f_all.append(np.asarray(fa))
        f_obs.append(np.asarray(fo))

    ik = JaxIK(jr, "hand", "hand", collision_avoidance=False, iterations=cfg.ik_iterations)
    q, ep, er, _ = ik.solve_ik_batch(np.tile(QC, (B * G, 1)), base_frame_goals(obs).reshape(-1, 4, 4))
    ep, er = np.asarray(ep).reshape(B, G), np.asarray(er).reshape(B, G)
    found = (ep < 0.01) & (er < 5.0)
    q_best = np.asarray(q).reshape(B, G, -1)[np.arange(B), np.argmin(ep + 2e-3 * er, axis=1)]
    X0 = np.stack([
        np.asarray(interpolate_waypoints_jnp(jnp.asarray(QC), jnp.asarray(qb), cfg.T - 2))
        for qb in q_best
    ])[..., :7]
    keep = np.stack(keep)
    gm = keep & found
    gm = np.where(gm.any(axis=1, keepdims=True), gm, True)
    return {
        "f_all": np.stack(f_all), "f_obs": np.stack(f_obs), "keep": keep, "found": found,
        "goal_mask": gm, "X0": X0,
    }


def jax_plan(jr, obs, f_all, f_obs, X0, goal_mask):
    """The goal-set plan over per-problem stacked fields through the JAX
    package: (Q, cost) as numpy."""
    cfg = CFG
    B, G = obs.grasps_world.shape[:2]
    planner = JaxPlanner(
        jr, "hand", "hand", single_pass=True, iterations=cfg.plan_iterations,
        coarse_iterations=cfg.coarse_iterations, final_trust=cfg.final_trust,
        standoff_distance=cfg.standoff_distance, T=cfg.T,
    )
    tables, base = planner.pack_stacked_fields(f_all, f_obs)
    params = {
        "q_param": jnp.tile(jnp.asarray(QC[7:]), (B, 1)),
        "tf_goal": jnp.asarray(base_frame_goals(obs)),
        "goal_mask": jnp.asarray(goal_mask),
        "base_position": jnp.tile(jnp.asarray(obs.base_position), (B, 1)),
        "field_base": base,
    }
    Q, cost, _ = planner.setup_optimization(G, True, cfg.axis_standoff).solve_batch_stacked(
        jnp.tile(jnp.asarray(QC[:7]), (B, 1)), jnp.asarray(X0), params, {"packed_fields": tables}
    )
    return np.asarray(Q), np.asarray(cost)
