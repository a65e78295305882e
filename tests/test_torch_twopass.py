"""The goal-set trajectory solver's two-pass iteration (the candidate
ladder as one batched residual pass), with the Thomas and the
cyclic-reduction KKT step, against the JAX package, float64: Q to 1e-8,
the same costs, active goals, damping and accept counts. (The single-pass
solver with cyclic reduction is in test_torch_cr.py.)"""

import pytest

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)

from torch_parity import make_jax_synth_robot, port_robot
from trajectory_parity import check_trajectory_solver


@pytest.fixture(scope="module")
def robots():
    jr = make_jax_synth_robot(points_per_link=10)
    return jr, port_robot(jr)


@pytest.mark.parametrize(
    "iterations,alphas,cyclic_reduction",
    [
        (3, (1.0,), False),
        (6, (1.0, 0.5), True),
    ],
)
def test_two_pass_solver_matches_jax(robots, iterations, alphas, cyclic_reduction):
    check_trajectory_solver(
        robots, iterations=iterations, coarse=0, final_trust=False, coherence=0.0,
        single_pass=False, cyclic_reduction=cyclic_reduction, lm_alphas=alphas, atol=1e-8,
    )

