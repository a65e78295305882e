"""The goal-set trajectory solve built in both packages on one problem:
B=2 problems with 4 goals each, per-problem stacked fields and base
positions, one goal slot masked out (the synthetic arm, float64)."""

from __future__ import annotations

import numpy as np
import torch

import jax.numpy as jnp

from grasptrajopt_tpu.planning.gto_planner import GTOPlanner as JaxPlanner
from grasptrajopt_tpu.testing import SYNTH_DEFAULT_POSE, make_synthetic_goal, make_synthetic_scene_field
from grasptrajopt_tpu_torch.convert import params_from_numpy
from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner
from torch_parity import np_, t64


def _problem(jr):
    rng = np.random.default_rng(11)
    B, G = 2, 4
    tf_goal = np.stack([
        np.stack([make_synthetic_goal(seed=4 * b + g) for g in range(G)]) for b in range(B)
    ])
    f_all = np.stack([make_synthetic_scene_field(jr, seed=b) for b in range(B)]).astype(np.float64)
    qc = SYNTH_DEFAULT_POSE.astype(np.float64)
    X0 = np.tile(qc[:7], (B, 48, 1)) + rng.normal(scale=0.05, size=(B, 48, 7))
    params = {
        "q_param": np.tile(qc[7:], (B, 1)),
        "tf_goal": tf_goal,
        "goal_mask": np.array([[True, True, False, True], [True] * 4]),
        "base_position": np.array([[0.0, 0.0, 0.0], [0.01, -0.02, 0.0]]),
        "goal_seed": np.array([3, 1], np.int32),
    }
    return qc, X0, f_all, 0.5 * f_all, params


def check_trajectory_solver(robots, iterations, coarse, final_trust, coherence):
    """Q to 1e-7, cost to 1e-9 relative, the same active goals and the same
    damping. lambda is lambda_init times 0.35 per accept and 4 per reject,
    so an equal final lambda means an equal number of accepts, and the
    port's recorded accept sequence must reproduce it; with Q equal to
    1e-7 the accept order is the same too."""
    jr, pr = robots
    qc, X0, f_all, f_obs, params = _problem(jr)
    kw = dict(iterations=iterations, coarse_iterations=coarse, final_trust=final_trust,
              standoff_distance=-0.1, goal_coherence=coherence)
    jp = JaxPlanner(jr, "hand", "hand", single_pass=True, **kw)
    tables, base = jp.pack_stacked_fields(f_all, f_obs)
    per = {k: jnp.asarray(v) for k, v in params.items()}
    per["field_base"] = base
    if coherence == 0.0:
        per.pop("goal_seed")
    Qj, cj, auxj = jp.setup_optimization(4, True, "z").solve_batch_stacked(
        jnp.tile(jnp.asarray(qc[:7]), (2, 1)), jnp.asarray(X0), per, {"packed_fields": tables}
    )

    pp = GTOPlanner(pr, "hand", "hand", **kw)
    per_t = params_from_numpy({k: np.array(v) for k, v in per.items()}, dtype=torch.float64)
    tables_t, base_t = pp.pack_stacked_fields(t64(f_all), t64(f_obs))
    np.testing.assert_array_equal(np_(tables_t), np.asarray(tables))
    np.testing.assert_array_equal(np_(base_t), np.asarray(base))
    Qp, cp, auxp = pp.setup_optimization(4, True, "z").solve_batch_stacked(
        t64(qc[:7]).expand(2, 7), t64(X0), per_t, {"packed_fields": tables_t}
    )

    np.testing.assert_allclose(np_(Qp), np.asarray(Qj), atol=1e-7, rtol=0)
    np.testing.assert_allclose(np_(cp), np.asarray(cj), rtol=1e-9, atol=0)
    np.testing.assert_array_equal(np_(auxp["step_aux"]), np.asarray(auxj["step_aux"]))
    np.testing.assert_array_equal(np_(auxp["lambda"]), np.asarray(auxj["lambda"]))
    acc = np_(auxp["accepts"])
    assert acc.shape == (2, iterations)
    lam = 1e-3 * np.prod(np.where(acc, 0.35, 4.0), axis=1)
    np.testing.assert_allclose(np_(auxp["lambda"]), lam, rtol=1e-12)
    return np_(Qp), np_(cp)
