"""Shared set-up of the IK collision-term parity tests: the synthetic arm
(10 points per link, 10 cm grid, float64) in both packages, a smooth
obstacle field on its grid (rising below z = 0.6 m, plus noise, so the
term has a value and a gradient at every body point), goals pushed into
it, and a base offset that puts no body point of the start pose on a cell
face (see test_torch_ik_collision.py for what happens on one)."""

from __future__ import annotations

import numpy as np

from grasptrajopt_tpu.planning.ik_solver import IKSolver as JaxIK
from grasptrajopt_tpu.testing import SYNTH_DEFAULT_POSE, make_synthetic_goal
from grasptrajopt_tpu_torch.planning.ik_solver import IKSolver
from torch_parity import jax_ik_restarts, make_jax_synth_robot, np_, port_robot, t64

QC = SYNTH_DEFAULT_POSE.astype(np.float64)
BASE = np.array([0.0137, -0.0271, 0.0313])
ITERS, SEEDS, N = 5, 4, 4


def robots_and_field():
    jr = make_jax_synth_robot(points_per_link=10, grid_resolution=0.1)
    rng = np.random.default_rng(3)
    z = jr.grid.grid_points(np.float64)[:, 2]
    field = np.maximum(0.0, 0.6 - z) * 0.5 + 0.01 * rng.random(jr.grid.size)
    goals = np.stack([make_synthetic_goal(seed=s) for s in range(N)])
    goals[:, 2, 3] -= 0.1
    return jr, port_robot(jr), field, goals


def solve_both(jr, pr, field, goals, multistart=False, **kw):
    """(JAX, port) results (q, err_pos, err_rot, col_cost) as numpy of one
    collision-avoiding solve_ik_batch; the port gets the JAX restarts."""
    jik = JaxIK(jr, "hand", "hand", collision_avoidance=True, iterations=ITERS, num_seeds=SEEDS, **kw)
    want = jik.solve_ik_batch(QC, goals, field, BASE, multistart=multistart, seed=0)
    ik = IKSolver(pr, "hand", "hand", iterations=ITERS, num_seeds=SEEDS, **kw)
    restarts = t64(jax_ik_restarts(jr, len(goals), SEEDS, 0)) if multistart else None
    got = ik.solve_ik_batch(t64(QC), t64(goals), t64(field), BASE, multistart=multistart, restarts=restarts)
    return [np.asarray(w) for w in want], [np_(g) for g in got], ik


def assert_match(want, got):
    """q and err_pos to 1e-8, err_rot to 1e-6 degrees, col_cost to 1e-10."""
    for w, g, tol in zip(want, got, (1e-8, 1e-8, 1e-6, 1e-10)):
        np.testing.assert_allclose(g, w, atol=tol, rtol=0)
