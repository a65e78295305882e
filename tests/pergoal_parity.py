"""The per-goal batch solve built in both packages on one small problem:
the synthetic arm (10 points per link, float64), T = 20, the first object
of scene 36 observed at 48x48, three of its grasps in a goal capacity of
4 (slot 3 re-solves goal 2), one IK-like start per goal, and the object's
scene point sets of 256 / 64 points made by `scene_point_sets_from_depth`.

Tolerances: Q 1e-8, cost 1e-8 relative, lambda equal. An equal final
lambda means an equal number of accepts (x0.35 per accept, x4 per
reject), and with Q equal to 1e-8 the accept order is the same. The JAX
CPU path computes K2's distances with the |q|^2 + |r|^2 - 2 q.r expansion
and the port with subtract-squares; in float64 that moves d2 by ~1e-16,
far below these tolerances."""

from __future__ import annotations

import numpy as np
import torch

from grasptrajopt_tpu.fields.scene_points import scene_point_sets_from_depth as jax_sets
from grasptrajopt_tpu.planning.gto_planner import GTOPlanner as JaxPlanner
from grasptrajopt_tpu.testing import SYNTH_DEFAULT_POSE
from grasptrajopt_tpu_torch.convert import scene_sets_from_numpy
from grasptrajopt_tpu_torch.e2e import SliceConfig, collect_observations
from grasptrajopt_tpu_torch.fields.scene_points import scene_point_sets_from_depth
from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner
from torch_parity import np_, t64

T, CAP, N_GOALS = 20, 4, 3
QC = SYNTH_DEFAULT_POSE.astype(np.float64)
OBS_CFG = SliceConfig(batch=2, goal_capacity=CAP, width=48, height=48, scenes=(36,))


def problem(seed: int = 0):
    """Host numpy inputs: observations of two objects, per object its
    base-frame goals (C, CAP, 4, 4), starts (C, CAP, ndof) and scene sets.
    The goals are rounded to float32, as the JAX plan_pergoal_batch stores
    them (its goal array is float32), so both packages solve one problem."""
    obs = collect_observations(OBS_CFG)
    tf_goal = obs.grasps_world.copy()
    tf_goal[..., :3, 3] -= obs.base_position
    tf_goal = tf_goal.astype(np.float32).astype(np.float64)
    rng = np.random.default_rng(seed)
    q_sols = np.tile(QC, (2, CAP, 1))
    q_sols[..., :7] += rng.normal(scale=0.3, size=(2, CAP, 7))
    sets = [
        scene_point_sets_from_depth(
            obs.depth[b], obs.K, obs.cam_pose[b], obs.target_mask[b],
            capacity_obstacle=256, capacity_target=64, resolution=0.02,
        )
        for b in range(2)
    ]
    return obs, tf_goal, q_sols, sets


def jax_sets_of(obs, b: int):
    return jax_sets(
        obs.depth[b], obs.K, obs.cam_pose[b], obs.target_mask[b],
        capacity_obstacle=256, capacity_target=64, resolution=0.02,
    )


def planner_kwargs(mode: str):
    """The exact tier's flavor in points mode, the main planner's (coarse
    2+1, final_trust) in field mode, both at 3 iterations."""
    if mode == "points":
        return dict(obstacle_mode="points", obstacle_weight=40.0, sdf_epsilon=0.03, iterations=3, T=T)
    return dict(iterations=3, coarse_iterations=2, final_trust=True, T=T)


def run_jax(jr, mode, obs, tf_goal, q_sols, b=0, fields=None):
    """JAX plan_pergoal_batch of object b: (Q (N_GOALS, T, ndof), cost,
    lambda (CAP,)); the solver's aux is captured from its cached program."""
    jp = JaxPlanner(jr, "hand", "hand", single_pass=True, standoff_distance=-0.1, **planner_kwargs(mode))
    jp.setup_optimization(CAP, True, "z")
    (key, solvers), = jp._solvers.items()
    seen = {}

    def spy(*args):
        out = solvers.solve_batch_shared(*args)
        seen["lambda"] = np.asarray(out[2]["lambda"])
        return out

    jp._solvers[key] = solvers._replace(solve_batch_shared=spy)
    so = st = None
    if mode == "points":
        so, st = jax_sets_of(obs, b)
    f_all, f_obs = (None, None) if fields is None else fields
    Q, cost = jp.plan_pergoal_batch(
        QC, tf_goal[b, :N_GOALS], f_all, f_obs, obs.base_position, q_sols[b, :N_GOALS].T,
        use_standoff=True, axis_standoff="z", goal_capacity=CAP, scene_obstacle=so, scene_target=st,
    )
    return np.asarray(Q).transpose(0, 2, 1), np.asarray(cost), seen["lambda"]


def check_against_jax(Qp, cp, aux, jax_out):
    """One object's port output (Q (CAP, T, ndof), cost (CAP,), aux)
    against run_jax's."""
    Qj, cj, lam = jax_out
    assert Qp.shape == (CAP, T, 9) and np.isfinite(Qp).all()
    np.testing.assert_allclose(Qp[:N_GOALS], Qj, atol=1e-8, rtol=0)
    np.testing.assert_allclose(cp[:N_GOALS], cj, rtol=1e-8, atol=0)
    np.testing.assert_array_equal(aux["lambda"], lam)
    acc = aux["accepts"]
    np.testing.assert_allclose(aux["lambda"], 1e-3 * np.prod(np.where(acc, 0.35, 4.0), axis=1), rtol=1e-12)
    assert acc.any()
    # the padding slot re-solves the last real goal
    np.testing.assert_array_equal(Qp[N_GOALS], Qp[N_GOALS - 1])


def run_port(pr, mode, obs, tf_goal, q_sols, sets, objects=(0,), fields=None):
    """The port's plan_pergoal_batch over the given objects in one batch:
    (Q (C, CAP, T, ndof), cost (C, CAP), aux)."""
    pp = GTOPlanner(pr, "hand", "hand", single_pass=True, standoff_distance=-0.1, **planner_kwargs(mode))
    ob = list(objects)
    scene = pack = None
    if mode == "points":
        scene = scene_sets_from_numpy([sets[b][0] for b in ob], [sets[b][1] for b in ob], device="cpu", dtype=torch.float64)
    else:
        pack = pp.pack_stacked_fields(t64(fields[0])[None], t64(fields[1])[None])
    Q, cost, aux = pp.plan_pergoal_batch(
        t64(QC), t64(tf_goal[ob]), torch.full((len(ob),), N_GOALS), t64(q_sols[ob]),
        t64(obs.base_position), True, "z", scene=scene, fields=pack,
    )
    return np_(Q), np_(cost), {k: np_(v) for k, v in aux.items()}
