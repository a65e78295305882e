"""The goal-set trajectory solver in the slice's flavor (single pass,
coarse 2+1, final_trust on) against the JAX package, float64, with the
goal-coherence branch of the active-goal selection."""

import pytest

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)

from torch_parity import make_jax_synth_robot, port_robot
from trajectory_parity import check_trajectory_solver


@pytest.fixture(scope="module")
def robots():
    jr = make_jax_synth_robot(points_per_link=10)
    return jr, port_robot(jr)


def test_trajectory_solver_final_trust_with_coherence(robots):
    check_trajectory_solver(robots, iterations=3, coarse=2, final_trust=True, coherence=2.0)
