"""The IK screen's batched box-constrained LM (single seed, no collision
term) against the JAX package in float64: joint solutions and position
errors to 1e-8, rotation errors to 1e-6 degrees."""

import numpy as np
import pytest

from grasptrajopt_tpu.planning.ik_solver import IKSolver as JaxIK
from grasptrajopt_tpu.testing import SYNTH_DEFAULT_POSE, make_synthetic_goal
from grasptrajopt_tpu_torch.planning.ik_solver import IKSolver
from torch_parity import make_jax_synth_robot, np_, port_robot, t64

RNG = np.random.default_rng(11)


@pytest.fixture(scope="module")
def robots():
    jr = make_jax_synth_robot(points_per_link=10)
    return jr, port_robot(jr)


def test_ik_batch_matches_jax(robots):
    jr, pr = robots
    N = 6
    RTs = np.stack([make_synthetic_goal(seed=s) for s in range(N)])
    RTs[:, :3, 3] += RNG.normal(scale=0.03, size=(N, 3))
    q0 = SYNTH_DEFAULT_POSE.astype(np.float64)
    qj, epj, erj, _ = JaxIK(jr, "hand", "hand", collision_avoidance=False, iterations=20).solve_ik_batch(
        np.tile(q0, (N, 1)), RTs
    )
    qp, epp, erp, colp = IKSolver(pr, "hand", "hand", collision_avoidance=False, iterations=20).solve_ik_batch(
        t64(q0), t64(RTs)
    )
    np.testing.assert_allclose(np_(qp), qj, atol=1e-8)
    np.testing.assert_allclose(np_(epp), epj, atol=1e-8)
    np.testing.assert_allclose(np_(erp), erj, atol=1e-6)
    assert (epj < 0.01).any()  # the screen reaches some goals
    assert not colp.any()  # no collision term: zero collision cost
