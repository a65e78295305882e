"""`GTOPlanner.plan_goalset_batch` against the JAX package, float64: B = 2
problems with their own fields, goal sets with a masked slot and warm
starts (the synthetic arm, 10 points per link, T = 12, the slice's
flavour); the port packs the fields into one stacked table, the JAX
package vmaps per-problem tables. Q to 1e-8, cost to 1e-9 relative."""

import numpy as np

import jax.numpy as jnp

from grasptrajopt_tpu.planning.gto_planner import GTOPlanner as JaxPlanner
from grasptrajopt_tpu.testing import SYNTH_DEFAULT_POSE, make_synthetic_goal, make_synthetic_scene_field
from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner
from torch_parity import make_jax_synth_robot, np_, port_robot

T = 12


def test_plan_goalset_batch_matches_jax():
    jr = make_jax_synth_robot(points_per_link=10)
    pr = port_robot(jr)
    rng = np.random.default_rng(9)
    B, G = 2, 3
    qc = np.tile(SYNTH_DEFAULT_POSE, (B, 1))
    tf_goal = np.stack([np.stack([make_synthetic_goal(seed=3 * b + g) for g in range(G)]) for b in range(B)])
    goal_mask = np.array([[True, False, True], [True, True, True]])
    f_all = np.stack([make_synthetic_scene_field(jr, seed=b) for b in range(B)]).astype(np.float64)
    f_obs = 0.5 * f_all
    base = np.array([[0.0, 0.0, 0.0], [0.02, -0.01, 0.0]])
    Q0 = np.tile(SYNTH_DEFAULT_POSE, (B, T, 1))
    Q0[..., :7] += rng.normal(scale=0.05, size=(B, T, 7))
    kw = dict(T=T, iterations=3, single_pass=True, coarse_iterations=2, final_trust=True, standoff_distance=-0.1)
    args = (qc, tf_goal, goal_mask, f_all, f_obs, base, Q0)
    Qj, cj = JaxPlanner(jr, "hand", "hand", **kw).plan_goalset_batch(
        *(jnp.asarray(a) for a in args), axis_standoff="z"
    )
    Qp, cp = GTOPlanner(pr, "hand", "hand", **kw).plan_goalset_batch(*args, axis_standoff="z")
    assert tuple(Qp.shape) == (B, T, 9)
    np.testing.assert_allclose(np_(Qp), np.asarray(Qj), atol=1e-8, rtol=0)
    np.testing.assert_allclose(np_(cp), np.asarray(cj), rtol=1e-9, atol=0)
    np.testing.assert_array_equal(np_(Qp)[:, :2], qc[:, None].repeat(2, axis=1))
