"""The per-goal tiers' solve, `GTOPlanner.plan_pergoal_batch`, against the
JAX package in float64 on the CPU (see pergoal_parity.py for the problem):
points mode (the exact tier) and the seed trajectories. The field branch
(the rescue tier) is test_torch_pergoal_field.py, the batch-first
two-object call test_torch_pergoal_batch.py.

Tolerances: see pergoal_parity.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from grasptrajopt_tpu.planning.gto_planner import GTOPlanner as JaxPlanner
from grasptrajopt_tpu_torch.ops import nn
from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner
from pergoal_parity import CAP, QC, T, check_against_jax, jax_sets_of, problem, run_jax, run_port
from torch_parity import make_jax_synth_robot, np_, port_robot, t64


@pytest.fixture(scope="module")
def setup():
    jr = make_jax_synth_robot(points_per_link=10)
    return jr, port_robot(jr), problem()


def test_scene_sets_copy_matches(setup):
    jr, pr, (obs, tf_goal, q_sols, sets) = setup
    for b in range(2):
        for mine, theirs in zip(sets[b], jax_sets_of(obs, b)):
            np.testing.assert_array_equal(mine.points, theirs.points)
            np.testing.assert_array_equal(mine.normals, theirs.normals)
            assert mine.count == theirs.count and mine.resolution == theirs.resolution
    assert sets[0][0].count > 0 and sets[0][1].count > 0


def test_pergoal_points_mode_matches_jax(setup):
    jr, pr, (obs, tf_goal, q_sols, sets) = setup
    before = nn.nearest_launches
    Qp, cp, aux = run_port(pr, "points", obs, tf_goal, q_sols, sets)
    assert nn.nearest_launches == before  # CPU tensors take the plain K2
    check_against_jax(Qp[0], cp[0], aux, run_jax(jr, "points", obs, tf_goal, q_sols))
    assert cp.min() > 0.0


def test_seed_trajectories_match_jax(setup):
    jr, pr, (obs, tf_goal, q_sols, sets) = setup
    want = JaxPlanner(jr, "hand", "hand", T=T)._seed_trajectories(jnp.asarray(QC), jnp.asarray(q_sols[0].T))
    got = GTOPlanner(pr, "hand", "hand", T=T)._seed_trajectories(t64(QC), t64(q_sols[0]))
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=1e-15, rtol=0)
    np.testing.assert_array_equal(np_(got)[..., 7:], np.broadcast_to(QC[7:], (CAP, T, 2)))


def test_points_mode_refuses_coarse_phase(setup):
    jr, pr, _ = setup
    planner = GTOPlanner(pr, "hand", "hand", obstacle_mode="points", coarse_iterations=2, T=T)
    with pytest.raises(NotImplementedError):
        planner.setup_optimization(CAP, True, "z")
