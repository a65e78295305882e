"""The perception-to-plan slice, first half: the port's fields, grasp
pre-filter, multistart IK screen, ranked warm start and goal mask against
the same chain through the JAX package (see slice_parity.py for the
sizes). Tolerances: fields 1e-10, pre-filter / IK gates / goal mask /
ranked seed goal exact, IK solutions and X0 1e-8. The plan is
test_torch_slice_plan.py, with the rescue and the gates."""

import numpy as np
import pytest

from slice_parity import jax_upstream, run_port


@pytest.fixture(scope="module")
def both():
    jr, obs, port = run_port()
    return port, jax_upstream(jr, obs)


def test_slice_fields(both):
    port, want = both
    np.testing.assert_allclose(port["f_all"], want["f_all"], atol=1e-10, rtol=0)
    np.testing.assert_allclose(port["f_obs"], want["f_obs"], atol=1e-10, rtol=0)
    assert want["f_obs"].max() > 0.0  # the scene reaches into the grid


def test_slice_goal_mask_and_warm_start(both):
    port, want = both
    for k in ("keep", "found", "goal_mask"):
        np.testing.assert_array_equal(port[k], want[k], err_msg=k)
    np.testing.assert_allclose(port["X0"], want["X0"], atol=1e-8, rtol=0)


def test_slice_ranking(both):
    port, want = both
    np.testing.assert_allclose(port["q_sols"], want["q_sols"], atol=1e-8, rtol=0)
    np.testing.assert_array_equal(port["seed_goal"], want["seed_goal"])
    assert want["found"].any() and not want["found"].all()  # the ranking has misses to put at inf
