"""Multistart IK against the JAX package, float64: the JAX package's own
restarts, drawn with jax.random exactly as its solver draws them, handed
to the port as `restarts`; every goal's seed and restarts run as one LM
batch and the lowest cost wins. q to 1e-8, err_pos to 1e-8, err_rot to
1e-6 degrees (as tests/test_torch_ik.py).

5 LM iterations: the seeds' costs then still differ by far more than
rounding, so both packages pick the same winner; at 20 several seeds reach
the goal to ~1e-33 and the winner among them is rounding noise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grasptrajopt_tpu.planning.ik_solver import IKSolver as JaxIK
from grasptrajopt_tpu.testing import SYNTH_DEFAULT_POSE, make_synthetic_goal
from grasptrajopt_tpu_torch.planning.ik_solver import IKSolver
from torch_parity import make_jax_synth_robot, np_, port_robot, t64

ITERS, SEEDS = 5, 4
QC = SYNTH_DEFAULT_POSE.astype(np.float64)


def jax_restarts(jr, key, count):
    """The restarts JAX's run_multistart draws from `key`: (count, n)."""
    lo = jnp.asarray(jr.lower_optimized_joint_limits, jnp.float64)
    hi = jnp.asarray(jr.upper_optimized_joint_limits, jnp.float64)
    lo_s, hi_s = jnp.clip(lo, -3.2, 3.2), jnp.clip(hi, -3.2, 3.2)
    return np.asarray(lo_s + jax.random.uniform(key, (count, lo.shape[0]), dtype=jnp.float64) * (hi_s - lo_s))


@pytest.fixture(scope="module")
def setup():
    jr = make_jax_synth_robot(points_per_link=10)
    rng = np.random.default_rng(4)
    goals = np.stack([make_synthetic_goal(seed=s) for s in range(5)])
    # turn some goals about world z, which a start far from them may miss
    for i, yaw in enumerate(rng.uniform(-2.5, 2.5, size=5)):
        c, s = np.cos(yaw), np.sin(yaw)
        goals[i, :3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ goals[i, :3, :3]
    return jr, port_robot(jr), goals


def test_multistart_batch_matches_jax(setup):
    jr, pr, goals = setup
    B = goals.shape[0]
    jik = JaxIK(jr, "hand", "hand", collision_avoidance=False, iterations=ITERS, num_seeds=SEEDS)
    qj, epj, erj, _ = jik.solve_ik_batch(QC, goals, multistart=True, seed=0)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    restarts = np.stack([jax_restarts(jr, keys[b], SEEDS - 1) for b in range(B)])
    ik = IKSolver(pr, "hand", "hand", collision_avoidance=False, iterations=ITERS, num_seeds=SEEDS)
    qp, epp, erp, _ = ik.solve_ik_batch(t64(QC), t64(goals), multistart=True, restarts=t64(restarts))
    np.testing.assert_allclose(np_(qp), qj, atol=1e-8)
    np.testing.assert_allclose(np_(epp), epj, atol=1e-8)
    np.testing.assert_allclose(np_(erp), erj, atol=1e-6)
    # the restarts matter: some goal's winner is not the plain seed's solution
    q1, _, _, _ = ik.solve_ik_batch(t64(QC), t64(goals))
    assert not np.allclose(np_(q1), qj, atol=1e-6)


def test_multistart_single_goal_matches_jax(setup):
    jr, pr, goals = setup
    jik = JaxIK(jr, "hand", "hand", collision_avoidance=False, iterations=ITERS, num_seeds=SEEDS)
    qj, epj, erj, _ = jik.solve_ik(QC, goals[2], verbose=False, multistart=True, seed=5)
    restarts = jax_restarts(jr, jax.random.PRNGKey(5), SEEDS - 1)
    ik = IKSolver(pr, "hand", "hand", collision_avoidance=False, iterations=ITERS, num_seeds=SEEDS)
    qp, epp, erp, _ = ik.solve_ik(t64(QC), t64(goals[2]), verbose=False, multistart=True, restarts=t64(restarts))
    np.testing.assert_allclose(np_(qp), qj, atol=1e-8)
    assert abs(epp - epj) <= 1e-8 and abs(erp - erj) <= 1e-6


def test_multistart_draws_from_its_seed(setup):
    """Without explicit restarts: a torch.Generator on the solver's
    device, seeded; the same seed gives the same solutions."""
    _, pr, goals = setup
    ik = IKSolver(pr, "hand", "hand", collision_avoidance=False, iterations=3, num_seeds=SEEDS)
    a = ik.solve_ik_batch(t64(QC), t64(goals), multistart=True, seed=1)
    b = ik.solve_ik_batch(t64(QC), t64(goals), multistart=True, seed=1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    lo = t64(pr.lower_optimized_joint_limits)
    hi = t64(pr.upper_optimized_joint_limits)
    q_opt = pr.extract_optimized_dimensions(a[0])
    assert bool(((q_opt >= lo) & (q_opt <= hi)).all())
