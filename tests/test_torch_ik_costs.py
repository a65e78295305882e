"""The IK screen's other costs against the JAX package, float64
(ik_collision_parity.py), each with the trilinear collision term:
'quaternion' (position + sqrt(1 - <q, q*>^2)) and 'rpy' (position + RPY
differences), single start. q to 1e-8, col_cost to 1e-10."""

import pytest
import torch

from grasptrajopt_tpu_torch.planning.ik_solver import IKSolver
from ik_collision_parity import QC, assert_match, robots_and_field, solve_both
from torch_parity import t64


@pytest.fixture(scope="module")
def setup():
    return robots_and_field()


@pytest.mark.parametrize("cost", ["quaternion", "rpy"])
def test_cost_matches_jax(setup, cost):
    jr, pr, field, goals = setup
    want, got, _ = solve_both(jr, pr, field, goals, cost=cost)
    assert_match(want, got)


def test_unknown_cost_and_interp_raise(setup):
    _, pr, _, _ = setup
    with pytest.raises(ValueError):
        IKSolver(pr, "hand", "hand", cost="euler")
    with pytest.raises(ValueError):
        IKSolver(pr, "hand", "hand", interp="cubic")
    with pytest.raises(ValueError):  # the collision term needs its field
        IKSolver(pr, "hand", "hand").solve_ik_batch(t64(QC), torch.eye(4, dtype=torch.float64)[None])
