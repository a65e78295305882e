"""Cyclic reduction (`block_tridiag_solve_cr`) against the Thomas solve,
a dense solve and the JAX package's cyclic reduction, float64, at horizons
that do and do not fill a 2^k - 1 level structure, to 1e-10; and the
long-horizon flavour's trajectory solver (single pass, coarse 2+1,
final_trust, cyclic reduction) against the JAX package's, Q to 1e-8."""

import numpy as np
import pytest

import jax.numpy as jnp

from grasptrajopt_tpu.ops.block_tridiag import block_tridiag_solve_cr as jax_cr
from grasptrajopt_tpu_torch.ops.block_tridiag import block_tridiag_solve, block_tridiag_solve_cr
from torch_parity import make_jax_synth_robot, np_, port_robot, t64
from trajectory_parity import check_trajectory_solver

TOL = 1e-10


def _system(T, n=7, seed=0):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(T - 1, n, n)) * 0.3
    A = rng.normal(size=(T, n, n))
    D = A @ A.transpose(0, 2, 1) + 2.0 * n * np.eye(n)
    return D, L, rng.normal(size=(T, n))


def _dense(D, L):
    T, n, _ = D.shape
    H = np.zeros((T * n, T * n))
    for t in range(T):
        H[t * n:(t + 1) * n, t * n:(t + 1) * n] = D[t]
    for t in range(T - 1):
        H[(t + 1) * n:(t + 2) * n, t * n:(t + 1) * n] = L[t]
        H[t * n:(t + 1) * n, (t + 1) * n:(t + 2) * n] = L[t].T
    return H


@pytest.mark.parametrize("T", [1, 2, 3, 7, 8, 50])
def test_cyclic_reduction_matches_thomas_dense_and_jax(T):
    D, L, b = _system(T)
    x = np_(block_tridiag_solve_cr(t64(D), t64(L), t64(b)))
    np.testing.assert_allclose(x, np_(block_tridiag_solve(t64(D), t64(L), t64(b))), atol=TOL, rtol=0)
    np.testing.assert_allclose(x.reshape(-1), np.linalg.solve(_dense(D, L), b.reshape(-1)), atol=TOL, rtol=0)
    np.testing.assert_allclose(x, np.asarray(jax_cr(jnp.asarray(D), jnp.asarray(L), jnp.asarray(b))), atol=TOL, rtol=0)
    # batch-first: a batch of two systems solves each as alone
    D2, L2, b2 = _system(T, seed=1)
    xb = np_(block_tridiag_solve_cr(t64(np.stack([D, D2])), t64(np.stack([L, L2])), t64(np.stack([b, b2]))))
    np.testing.assert_allclose(xb[0], x, atol=TOL, rtol=0)
    np.testing.assert_allclose(xb[1], np_(block_tridiag_solve(t64(D2), t64(L2), t64(b2))), atol=TOL, rtol=0)


def test_single_pass_cyclic_reduction_solver_matches_jax():
    jr = make_jax_synth_robot(points_per_link=10)
    check_trajectory_solver(
        (jr, port_robot(jr)), iterations=3, coarse=2, final_trust=True, coherence=0.0,
        cyclic_reduction=True, atol=1e-8,
    )
