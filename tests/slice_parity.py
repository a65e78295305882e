"""The perception-to-plan slice at a tiny size, through the port
(`grasptrajopt_tpu_torch.e2e.PerceptionToPlan`) and through the JAX
package's library calls in the same order (bench_e2e.py's fields ->
multistart IK -> ranking -> plan -> rescue chain), float64 on the CPU.

Two objects of scene 36 at 48x48, the synthetic arm with 10 points per
link on a 10 cm workspace grid (the 5 cm grid's field build is too slow
for a CPU test), 8 goals per object, the IK screen at 10 iterations with
4 seeds (the port given the JAX package's restarts), the ranking at
strides (4, 4), plan 3 iterations with the coarse 2+1 schedule and
final_trust, the rescue of the worst object.
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
from torch_parity import make_jax_synth_gripper, make_jax_synth_robot, np_, port_robot, use_jax_restarts

CFG = SliceConfig(
    batch=2, goal_capacity=8, width=48, height=48, scenes=(36,),
    ik_iterations=10, ik_seeds=4, plan_iterations=3, coarse_iterations=2, final_trust=True,
)
QC = SYNTH_DEFAULT_POSE.astype(np.float64)


def run_port(cfg=CFG):
    """(JAX robot, observations, the port's slice outputs as numpy)."""
    jr = make_jax_synth_robot(points_per_link=10, grid_resolution=0.1)
    obs = collect_observations(cfg)
    before = pnn.min_d2_launches
    gripper = make_synthetic_gripper(device="cpu", dtype=torch.float64, points_per_link=10)
    path = PerceptionToPlan(port_robot(jr), gripper, cfg)
    use_jax_restarts(path.ik, jr)
    out = path.run(obs)
    assert pnn.min_d2_launches == before  # CPU tensors take the plain K1
    port = {k: np_(out[k]) for k in (
        "keep", "found", "goal_mask", "X0", "seed_goal", "q_sols", "Q_plan", "Q", "cost", "worst", "rescued",
    )}
    port["f_all"], port["f_obs"] = np_(out["fields"].f_all), np_(out["fields"].f_obs)
    port["gates"] = path.gates(obs, out)
    port["run"] = (path, out)
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

    # bench_e2e.py's phase_ik: the multistart screen (one key a goal from
    # PRNGKey(0)), then each object's seeds ranked by the planner's helpers
    ik = JaxIK(jr, "hand", "hand", collision_avoidance=False, iterations=cfg.ik_iterations,
               num_seeds=cfg.ik_seeds)
    q, ep, er, _ = ik.solve_ik_batch(
        np.tile(QC, (B * G, 1)), base_frame_goals(obs).reshape(-1, 4, 4), multistart=True, seed=0
    )
    ep, er = np.asarray(ep).reshape(B, G), np.asarray(er).reshape(B, G)
    found = (ep < 0.01) & (er < 5.0)
    q_sols = np.asarray(q).reshape(B, G, -1)
    planner = jax_planner(jr, G)
    X0, seed_goal = [], []
    for b in range(B):
        seeds = planner._seed_trajectories(jnp.asarray(QC), jnp.asarray(q_sols[b]).T)
        costs, dists = planner.rank_seed_scores(seeds, jnp.asarray(f_obs[b]), jnp.asarray(obs.base_position))
        best = int(planner.rank_pick(jnp.where(jnp.asarray(found[b]), costs, jnp.inf), dists))
        X0.append(np.asarray(seeds[best])[2:, :7])
        seed_goal.append(best)
    keep = np.stack(keep)
    gm = keep & found
    gm = np.where(gm.any(axis=1, keepdims=True), gm, True)
    return {
        "f_all": np.stack(f_all), "f_obs": np.stack(f_obs), "keep": keep, "found": found,
        "goal_mask": gm, "X0": np.stack(X0), "seed_goal": np.asarray(seed_goal), "q_sols": q_sols,
    }


def jax_planner(jr, G):
    """The JAX planner at the slice's flavour (its rank strides too)."""
    cfg = CFG
    return JaxPlanner(
        jr, "hand", "hand", single_pass=True, iterations=cfg.plan_iterations,
        coarse_iterations=cfg.coarse_iterations, final_trust=cfg.final_trust,
        standoff_distance=cfg.standoff_distance, T=cfg.T,
        rank_t_stride=cfg.rank_t_stride, rank_p_stride=cfg.rank_p_stride,
    )


def jax_plan(jr, obs, f_all, f_obs, X0, goal_mask):
    """The goal-set plan over per-problem stacked fields through the JAX
    package: (Q, cost) as numpy."""
    cfg = CFG
    B, G = obs.grasps_world.shape[:2]
    planner = jax_planner(jr, G)
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


def jax_rescue(jr, obs, Q, tables, base, goal_mask, q_sols):
    """bench_e2e.py's phase_rescue through the JAX package on the port's
    goal-set plans Q (B, T, 7), stacked tables (as numpy), goal mask and IK
    solutions: (Q, worst, better) as numpy."""
    from grasptrajopt_tpu.spatial import r2quat
    from grasptrajopt_tpu.spatial.quaternion import qangle_deg

    cfg = CFG
    B, G = obs.grasps_world.shape[:2]
    K, T = cfg.rescue_k, cfg.T
    tf_goal = jnp.asarray(base_frame_goals(obs))
    q_param = jnp.tile(jnp.asarray(QC[7:]), (B, 1))

    def full(Qo, qp):
        return jnp.concatenate([Qo, jnp.broadcast_to(qp[:, None, :], Qo.shape[:2] + (2,))], axis=-1)

    T_end = jr.get_global_link_transform("hand", full(jnp.asarray(Q), q_param)[:, -1])
    d = jnp.linalg.norm(tf_goal[..., :3, 3] - T_end[:, None, :3, 3], axis=-1)
    rot = qangle_deg(r2quat(tf_goal[..., :3, :3]), jnp.broadcast_to(r2quat(T_end[:, None, :3, :3]), (B, G, 4)))
    err0 = jnp.min(jnp.where(goal_mask, d + 2e-3 * rot, jnp.inf), axis=1)
    worst = jnp.argsort(-err0)[:K]
    tfk = tf_goal[worst].reshape(K * G, 1, 4, 4)
    q_sols_k = jnp.asarray(q_sols)[worst].reshape(K * G, -1)
    X0k = jnp.stack([interpolate_waypoints_jnp(jnp.asarray(QC), qs, T) for qs in q_sols_k])[:, 2:, :7]
    params = {
        "q_param": jnp.tile(jnp.asarray(QC[7:]), (K * G, 1)),
        "tf_goal": tfk,
        "goal_mask": jnp.ones((K * G, 1), bool),
        "base_position": jnp.tile(jnp.asarray(obs.base_position), (K * G, 1)),
        "field_base": jnp.repeat(jnp.asarray(base)[worst], G),
    }
    solvers1 = jax_planner(jr, 1).setup_optimization(1, True, cfg.axis_standoff)
    Qr, _, _ = solvers1.solve_batch_stacked(
        jnp.tile(jnp.asarray(QC[:7]), (K * G, 1)), X0k, params, {"packed_fields": jnp.asarray(tables)}
    )
    T_endr = jr.get_global_link_transform("hand", full(Qr, params["q_param"])[:, -1])
    dr = jnp.linalg.norm(tfk[:, 0, :3, 3] - T_endr[:, :3, 3], axis=-1)
    rotr = qangle_deg(r2quat(tfk[:, 0, :3, :3]), r2quat(T_endr[:, :3, :3]))
    errr = jnp.where(jnp.asarray(goal_mask)[worst].reshape(K * G), dr + 2e-3 * rotr, jnp.inf).reshape(K, G)
    bestg = jnp.argmin(errr, axis=1)
    better = errr[jnp.arange(K), bestg] < err0[worst]
    Q_repl = Qr.reshape(K, G, T, -1)[jnp.arange(K), bestg]
    Q_new = jnp.asarray(Q).at[worst].set(jnp.where(better[:, None, None], Q_repl, jnp.asarray(Q)[worst]))
    return np.asarray(Q_new), np.asarray(worst), np.asarray(better)


def jax_gates(jr, obs, Q, goal_mask):
    """bench_e2e.py's gates through the JAX package on plans Q (B, T, 7):
    reach fractions under both gates, the best goal's errors, and the
    replay collision against each object's obstacle cloud."""
    from grasptrajopt_tpu.spatial import r2quat
    from grasptrajopt_tpu.spatial.quaternion import qangle_deg

    cfg = CFG
    B = Q.shape[0]
    Q_full = np.concatenate([Q, np.broadcast_to(QC[7:], Q.shape[:2] + (2,))], axis=-1)
    tf_goal = base_frame_goals(obs)
    T_end = np.asarray(jr.get_global_link_transform("hand", jnp.asarray(Q_full[:, -1])))
    d = np.linalg.norm(tf_goal[:, :, :3, 3] - T_end[:, None, :3, 3], axis=-1)
    rot = np.asarray(qangle_deg(r2quat(jnp.asarray(tf_goal[..., :3, :3])),
                                jnp.broadcast_to(r2quat(jnp.asarray(T_end[:, None, :3, :3])), d.shape + (4,))))
    best = np.argmin(np.where(goal_mask, d + rot * 2e-3, np.inf), axis=1)
    pts = np.asarray(jr.fk_surface_points(jnp.asarray(Q_full), base_position=jnp.asarray(obs.base_position)))
    collisions = []
    for b in range(B):
        d_obs = np.array(obs.depth[b], copy=True)
        d_obs[obs.target_mask[b]] = cfg.depth_threshold
        cloud = jdpc.DepthPointCloud(d_obs, obs.K, obs.cam_pose[b], obs.target_mask[b], threshold=cfg.depth_threshold)
        inside = np.asarray(cloud.get_sdf(jnp.asarray(pts[b].reshape(-1, 3)), host=False)).reshape(cfg.T, -1) < 0
        collisions.append(bool(((inside & ~inside[0]).sum(axis=1) > 5).any()))
    return {
        "reached_ik": ((d < 0.01) & (rot < 5.0) & goal_mask).any(axis=1),
        "reached_plan": ((d < 0.02) & (rot < 10.0) & goal_mask).any(axis=1),
        "err_pos": d[np.arange(B), best], "err_rot": rot[np.arange(B), best], "collision": np.asarray(collisions),
    }
