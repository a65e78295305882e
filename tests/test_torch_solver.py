"""Solvers of the port against the JAX package in float64: the block-
tridiagonal KKT solve and the goal-set trajectory LM (single pass, coarse
phase, final_trust off; final_trust on is test_torch_trajectory.py)."""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)

from grasptrajopt_tpu.ops.block_tridiag import block_tridiag_matvec as jax_matvec
from grasptrajopt_tpu.ops.block_tridiag import block_tridiag_solve as jax_solve
from grasptrajopt_tpu_torch.ops.block_tridiag import block_tridiag_matvec, block_tridiag_solve
from torch_parity import make_jax_synth_robot, np_, port_robot, t64
from trajectory_parity import check_trajectory_solver

RNG = np.random.default_rng(11)


def _spd_block_tridiag(T=12, n=7):
    L = RNG.normal(size=(T - 1, n, n)) * 0.3
    A = RNG.normal(size=(T, n, n))
    D = A @ A.transpose(0, 2, 1) + 2.0 * n * np.eye(n)
    return D, L


def _dense(D, L):
    T, n, _ = D.shape
    H = np.zeros((T * n, T * n))
    for t in range(T):
        H[t * n:(t + 1) * n, t * n:(t + 1) * n] = D[t]
    for t in range(T - 1):
        H[(t + 1) * n:(t + 2) * n, t * n:(t + 1) * n] = L[t]
        H[t * n:(t + 1) * n, (t + 1) * n:(t + 2) * n] = L[t].T
    return H


def test_block_tridiag_solve_and_matvec():
    D, L = _spd_block_tridiag()
    b = RNG.normal(size=(12, 7))
    x = np_(block_tridiag_solve(t64(D), t64(L), t64(b)))
    x_dense = np.linalg.solve(_dense(D, L), b.reshape(-1)).reshape(12, 7)
    np.testing.assert_allclose(x, x_dense, atol=1e-10)
    np.testing.assert_allclose(x, np.asarray(jax_solve(D, L, b)), atol=1e-10)
    np.testing.assert_allclose(
        np_(block_tridiag_matvec(t64(D), t64(L), t64(x))), np.asarray(jax_matvec(D, L, x)), atol=1e-10
    )
    np.testing.assert_allclose(np_(block_tridiag_matvec(t64(D), t64(L), t64(x))), b, atol=1e-10)
    # leading batch dims are carried through
    D2, L2 = _spd_block_tridiag()
    xb = np_(block_tridiag_solve(t64(np.stack([D, D2])), t64(np.stack([L, L2])), t64(np.stack([b, b]))))
    np.testing.assert_allclose(xb[0], x_dense, atol=1e-10)
    np.testing.assert_allclose(xb[1], np.linalg.solve(_dense(D2, L2), b.reshape(-1)).reshape(12, 7), atol=1e-10)


@pytest.fixture(scope="module")
def robots():
    jr = make_jax_synth_robot(points_per_link=10)
    return jr, port_robot(jr)


def test_trajectory_solver_evaluated_finish(robots):
    """Single pass, coarse 2+1, final_trust off (the post-scan pass keeps
    the last trial point only if it improves)."""
    check_trajectory_solver(robots, iterations=3, coarse=2, final_trust=False, coherence=0.0)
