"""The perception-to-plan slice, second half, on one run of the port
(see slice_parity.py for the sizes; test_torch_slice.py shows that its
fields, warm start and goal mask agree with the JAX package's own chain:
fields 1e-10, X0 1e-8, goal mask exact):

  - the goal-set plan against the JAX package's on the same fields, warm
    start and goal mask (Q 1e-7, cost 1e-9 relative);
  - the goal-coherence bias: with coherence 1e3 the plan's active goal is
    the ranked seed's (the planner's coherence itself is held to the JAX
    package in test_torch_ranking.py);
  - the bounded rescue against bench_e2e.py's phase_rescue through the JAX
    package on the port's goal-set plans, stacked tables, goal mask and IK
    solutions (the rescued plans 1e-7, the rescued object and the applied
    flag exact);
  - the gates against bench_e2e.py's (reach and collision verdicts exact,
    the best goal's errors 1e-9 m / 1e-7 degrees)."""

import dataclasses

import numpy as np
import pytest
import torch

from grasptrajopt_tpu_torch.e2e import PerceptionToPlan
from grasptrajopt_tpu_torch.testing import make_synthetic_gripper
from slice_parity import CFG, jax_gates, jax_plan, jax_rescue, run_port
from torch_parity import np_


@pytest.fixture(scope="module")
def port_run():
    return run_port()


def test_slice_plan_matches_jax(port_run):
    jr, obs, port = port_run
    Q = port["Q_plan"]  # the goal-set plan, before the rescue
    assert Q.shape == (CFG.batch, CFG.T, 7) and np.isfinite(Q).all()
    assert np.isfinite(port["cost"]).all()
    Qj, cj = jax_plan(jr, obs, port["f_all"], port["f_obs"], port["X0"], port["goal_mask"])
    np.testing.assert_allclose(Q, Qj, atol=1e-7, rtol=0)
    np.testing.assert_allclose(port["cost"], cj, rtol=1e-9, atol=0)


def test_slice_plan_keeps_the_seed_goal_with_coherence(port_run):
    """PerceptionToPlan.plan with coherence 1e3 on the same run's warm
    start, tables and ranked seed goals hands the seed goals to the
    solver as goal_seed."""
    _, _, port = port_run
    path, out = port["run"]
    cfg = dataclasses.replace(CFG, goal_coherence=1e3)
    gripper = make_synthetic_gripper(device="cpu", dtype=torch.float64, points_per_link=10)
    coherent = PerceptionToPlan(path.robot, gripper, cfg)
    Q, cost, aux = coherent.plan(out["inputs"], out["X0"], out["tables"], out["field_base"], out["goal_mask"],
                                 out["seed_goal"])
    assert torch.isfinite(Q).all() and torch.isfinite(cost).all()
    np.testing.assert_array_equal(np_(aux["step_aux"]), port["seed_goal"])


def test_rescue_matches_jax(port_run):
    jr, obs, port = port_run
    # the JAX package's stacked table of the port's fields (the packing
    # itself is held bit for bit in test_torch_field_lookup.py)
    tables = np.concatenate([
        np.asarray(jr.grid.pack(port[f][b])) for b in range(CFG.batch) for f in ("f_all", "f_obs")
    ])
    base = np.arange(CFG.batch) * 2 * jr.grid.size
    Qj, worst, better = jax_rescue(jr, obs, port["Q_plan"], tables, base, port["goal_mask"], port["q_sols"])
    np.testing.assert_array_equal(port["worst"], worst)
    np.testing.assert_array_equal(port["rescued"], better)
    assert better.any()  # the rescue replaced a plan here
    np.testing.assert_allclose(port["Q"], Qj, atol=1e-7, rtol=0)


def test_gates_match_jax(port_run):
    jr, obs, port = port_run
    want = jax_gates(jr, obs, port["Q"], port["goal_mask"])
    got = port["gates"]
    assert got["reached_frac_ik_gates"] == float(np.mean(want["reached_ik"]))
    assert got["reached_frac_plan_gates"] == float(np.mean(want["reached_plan"]))
    assert got["collision_frac"] == float(np.mean(want["collision"]))
    np.testing.assert_allclose(got["err_pos_median"], np.median(want["err_pos"]), atol=1e-9)
    np.testing.assert_allclose(got["err_rot_median_deg"], np.median(want["err_rot"]), atol=1e-7)
    np.testing.assert_allclose(got["mean_ik_found"], np.mean(port["found"]))
