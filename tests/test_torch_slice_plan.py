"""The perception-to-plan slice, second half: the port's final plan against
the JAX package's goal-set plan on the same fields, warm start and goal
mask (see slice_parity.py for the sizes). test_torch_slice.py shows that
those inputs agree with the JAX package's own chain (fields 1e-10, X0
1e-8, goal mask exact); together the two files cover the whole slice.
Tolerances: Q 1e-7, cost 1e-9 relative."""

import numpy as np

from slice_parity import CFG, jax_plan, run_port


def test_slice_plan_matches_jax():
    jr, obs, port = run_port()
    Q = port["Q"]
    assert Q.shape == (CFG.batch, CFG.T, 7) and np.isfinite(Q).all()
    assert np.isfinite(port["cost"]).all()
    Qj, cj = jax_plan(jr, obs, port["f_all"], port["f_obs"], port["X0"], port["goal_mask"])
    np.testing.assert_allclose(Q, Qj, atol=1e-7, rtol=0)
    np.testing.assert_allclose(port["cost"], cj, rtol=1e-9, atol=0)
