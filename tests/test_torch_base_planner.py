"""The port's BasePlanner (planning/base_planner.py) against the JAX
package's, float64 on the CPU: synth7 at 10 points per link, 100 LM
iterations, the occupancy grid of the mobile harness's tabletop view
(48x48) built by the JAX robot and carried into the port's.

Goals are reachable hand poses pushed 0.8 m along +x, so the base must
move. Tolerances: the base pose y and the arm configurations Q within
1e-8, err_pos within 1e-9 m, err_rot within 1e-6 degrees (arccos
amplifies rounding near 0 degrees), col_cost equal (a count). Also the
JAX package's own scenario (tests/test_planning.py, the base moves toward
an out-of-reach goal) on the port, and the batched solve of candidate
subsets against single solves. Each goal size costs one JAX compile
(about 6 s)."""

import numpy as np
import pytest
import torch

from grasptrajopt_tpu.planning.base_planner import BasePlanner as JaxBasePlanner
from grasptrajopt_tpu.testing import SYNTH_DEFAULT_POSE, make_synthetic_goal
from grasptrajopt_tpu_torch.convert import occupancy_from_numpy
from grasptrajopt_tpu_torch.planning import BasePlanner
from torch_parity import make_jax_synth_robot, mobile_tabletop_cloud, port_robot

TOL_X = 1e-8  # y and Q
TOL_POS = 1e-9  # m
TOL_ROT = 1e-6  # degrees


@pytest.fixture(scope="module")
def robots():
    jr = make_jax_synth_robot(points_per_link=10)
    jr.setup_occupancy_grid(mobile_tabletop_cloud(48))
    pr = port_robot(jr)
    occupancy_from_numpy(pr, jr.occupancy.origin, jr.occupancy.shape, jr.occupancy.resolution,
                         np.asarray(jr.occupancy_grid))
    return jr, pr


def far_goals(n: int, shift: float = 0.8, seed: int = 0) -> np.ndarray:
    RTs = np.stack([make_synthetic_goal(seed=seed + i) for i in range(n)])
    RTs[:, 0, 3] += shift
    return RTs


def compare(got, want):
    Q, y, err_pos, err_rot, col = got
    Qj, yj, err_pos_j, err_rot_j, col_j = want
    assert Q.shape == np.asarray(Qj).shape and y.shape == (3,)
    np.testing.assert_allclose(y, yj, atol=TOL_X, rtol=0)
    np.testing.assert_allclose(Q, np.asarray(Qj), atol=TOL_X, rtol=0)
    np.testing.assert_allclose(err_pos, err_pos_j, atol=TOL_POS, rtol=0)
    np.testing.assert_allclose(err_rot, err_rot_j, atol=TOL_ROT, rtol=0)
    assert isinstance(col, float) and col == col_j


@pytest.mark.parametrize(
    "n_goals,qc,seed,iterations",
    [(1, SYNTH_DEFAULT_POSE, 0, 100), (4, np.zeros(9), 0, 100), (2, SYNTH_DEFAULT_POSE, 3, 10)],
    ids=["1 goal", "4 goals", "2 goals, 10 iterations"],
)
def test_plan_goalset_matches_jax(robots, n_goals, qc, seed, iterations):
    """On the third case's goals the LM amplifies rounding along the arm's
    null space (test_batched_subsets_equal_single_solves): it is held at
    10 iterations."""
    jr, pr = robots
    RTs = far_goals(n_goals, seed=seed)
    want = JaxBasePlanner(jr, "hand", "hand", iterations=iterations).plan_goalset(qc, RTs, verbose=False)
    got = BasePlanner(pr, "hand", "hand", iterations=iterations).plan_goalset(qc, RTs, verbose=False)
    compare(got, want)
    if iterations == 100:
        assert float(np.max(got[2])) < 0.05  # the goals are reached


def test_plan_goalset_with_a_distinct_end_effector_link(robots):
    """link_ee = l6: the goal poses place l6, the residual matches the
    hand through invt(T_l6) @ T_hand."""
    jr, pr = robots
    RTs = far_goals(2, shift=0.5, seed=7)
    want = JaxBasePlanner(jr, "l6", "hand").plan_goalset(SYNTH_DEFAULT_POSE, RTs, verbose=False)
    got = BasePlanner(pr, "l6", "hand").plan_goalset(SYNTH_DEFAULT_POSE, RTs, verbose=False)
    compare(got, want)


def test_base_moves_toward_out_of_reach_goal(robots):
    """The JAX package's scenario on synth7: the default hand pose pushed
    0.8 m along +x is out of reach from the fixed base; the base moves
    toward it (y, the old base in the new frame, has a negative x) and
    the hand reaches it."""
    _, pr = robots
    q = np.asarray(SYNTH_DEFAULT_POSE)
    RT = pr.get_global_link_transform("hand", torch.as_tensor(q)).numpy()
    RT[0, 3] += 0.8
    planner = BasePlanner(pr, "hand", "hand", iterations=100)
    planner.setup_optimization(goal_size=1)
    Q, y, err_pos, err_rot, col = planner.plan_goalset(q, RT[None], verbose=False)
    assert Q.shape == (pr.ndof, 1)
    assert y[0] < -0.2, f"base did not move: {y}"
    assert err_pos[0] < 0.05, f"err_pos {err_pos}"
    assert err_rot[0] < 10.0, f"err_rot {err_rot}"


def test_batched_subsets_equal_single_solves(robots):
    """plan_goalset_batch over 3 candidate subsets (the JAX package's
    vmapped _solver_batch) against 3 single solves, at 10 iterations: y
    and the cost within 1e-10, Q within 1e-9. The B = 1 and B = 3 solves
    round differently from the first iteration (1.6e-13), and on the
    second subset the LM amplifies that along the arm's null space about
    twofold an iteration (4e-10 in Q at 10 iterations, 1e-3 at 100, where
    both goals are reached within 1 cm either way; the JAX solver against
    the port's single solve: 1.8e-9 and 4e-3), while y stays within
    1e-12 at 10 iterations."""
    _, pr = robots
    subsets = np.stack([far_goals(2, seed=3 * b) for b in range(3)])
    planner = BasePlanner(pr, "hand", "hand", iterations=10)
    Q, y, cost = planner.plan_goalset_batch(SYNTH_DEFAULT_POSE, subsets)
    assert Q.shape == (3, pr.ndof, 2) and y.shape == (3, 3) and cost.shape == (3,)
    for b in range(3):
        Qb, yb, cb = planner.plan_goalset_batch(SYNTH_DEFAULT_POSE, subsets[b:b + 1])
        np.testing.assert_allclose(y[b], yb[0], atol=1e-10, rtol=0)
        np.testing.assert_allclose(cost[b], cb[0], atol=1e-10, rtol=0)
        np.testing.assert_allclose(Q[b], Qb[0], atol=1e-9, rtol=0)
        Qs, ys, _, _, _ = planner.plan_goalset(SYNTH_DEFAULT_POSE, subsets[b], verbose=False)
        np.testing.assert_array_equal(Qs, Qb[0])
        np.testing.assert_array_equal(ys, yb[0])
