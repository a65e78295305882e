"""The per-goal solve batch-first over objects (the port's own layout, no
JAX counterpart): problems grouped by object and each object's scene sets
stacked, one batch of two objects gives what two one-object calls give,
in float64 on the CPU (the problem of pergoal_parity.py)."""

import numpy as np

from pergoal_parity import problem, run_port
from torch_parity import make_jax_synth_robot, port_robot


def test_pergoal_two_objects_equal_two_single_calls():
    pr = port_robot(make_jax_synth_robot(points_per_link=10))
    obs, tf_goal, q_sols, sets = problem()
    Q2, c2, _ = run_port(pr, "points", obs, tf_goal, q_sols, sets, objects=(0, 1))
    for b in range(2):
        Q1, c1, _ = run_port(pr, "points", obs, tf_goal, q_sols, sets, objects=(b,))
        np.testing.assert_allclose(Q2[b], Q1[0], atol=1e-12, rtol=0)
        np.testing.assert_allclose(c2[b], c1[0], rtol=1e-12, atol=0)
    assert not np.allclose(Q2[0], Q2[1])
