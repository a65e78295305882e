"""Inverse dynamics against the JAX package's, float64 on the CPU: the
pendulum's and the double pendulum's rnea, mass matrix, Coriolis and
gravity vectors at random states within 1e-10 (and the pendulum against
its closed form), the decomposition tau = M qdd + C + g, the inverse
dynamics of a re-rooted model (add_base_frame), and rnea's cache per
gravity vector."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grasptrajopt_tpu.models import RobotModel as JaxRobot
from grasptrajopt_tpu.models import dynamics as jdyn
from grasptrajopt_tpu_torch.models import RobotModel
from grasptrajopt_tpu_torch.models import dynamics as tdyn
from test_dynamics import DOUBLE_PENDULUM, PENDULUM
from torch_parity import np_, t64

TOL = 1e-10


def _robots(urdf):
    return (JaxRobot(urdf_string=urdf, dtype=jnp.float64),
            RobotModel(urdf_string=urdf, dtype=torch.float64, device="cpu"))


def _states(n, count=4, seed=0):
    rng = np.random.default_rng(seed)
    return [tuple(rng.uniform(-1.5, 1.5, size=n) for _ in range(3)) for _ in range(count)]


@pytest.mark.parametrize("urdf", [PENDULUM, DOUBLE_PENDULUM], ids=["pendulum", "double_pendulum"])
def test_rnea_mass_coriolis_gravity_match(urdf):
    jr, tr = _robots(urdf)
    jid = jdyn.make_inverse_dynamics(jr)
    for q, qd, qdd in _states(tr.ndof):
        qj, qdj, qddj = (jnp.asarray(v) for v in (q, qd, qdd))
        qt, qdt, qddt = (t64(v) for v in (q, qd, qdd))
        tau = np_(tr.rnea(qt, qdt, qddt))
        np.testing.assert_allclose(tau, np.asarray(jid(qj, qdj, qddj)), atol=TOL, rtol=TOL)
        M = np_(tdyn.mass_matrix(tr, qt))
        np.testing.assert_allclose(M, np.asarray(jdyn.mass_matrix(jr, qj)), atol=TOL, rtol=TOL)
        c = np_(tdyn.coriolis_vector(tr, qt, qdt))
        np.testing.assert_allclose(c, np.asarray(jdyn.coriolis_vector(jr, qj, qdj)), atol=TOL, rtol=TOL)
        g = np_(tdyn.gravity_vector(tr, qt))
        np.testing.assert_allclose(g, np.asarray(jdyn.gravity_vector(jr, qj)), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(tau, M @ qdd + c + g, atol=TOL)
        np.testing.assert_allclose(M, M.T, atol=TOL)


def test_pendulum_closed_form():
    _, tr = _robots(PENDULUM)
    m, l, g = 2.0, 0.8, 9.81
    for q, qd, qdd in [(0.0, 0.0, 0.0), (0.5, 0.3, -0.2), (-1.2, 1.0, 2.0)]:
        tau = float(tr.rnea(t64([q]), t64([qd]), t64([qdd]))[0])
        np.testing.assert_allclose(tau, m * l**2 * qdd + m * g * l * np.sin(q), atol=1e-9)


def test_rnea_caches_per_gravity():
    jr, tr = _robots(DOUBLE_PENDULUM)
    q, qd, qdd = (t64(v) for v in _states(2, count=1, seed=4)[0])
    tau = tr.rnea(q, qd, qdd)
    first = tr._idyn_cache[1]
    assert torch.equal(tr.rnea(q, qd, qdd), tau) and tr._idyn_cache[1] is first
    moon = (0.0, 0.0, -1.62)
    got = np_(tr.rnea(q, qd, qdd, gravity=moon))
    assert tr._idyn_cache[0] == moon
    want = jr.rnea(*(jnp.asarray(np_(v)) for v in (q, qd, qdd)), gravity=moon)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


def test_add_base_frame_then_dynamics():
    jr, tr = _robots(DOUBLE_PENDULUM)
    for r in (jr, tr):
        r.add_base_frame("world", xyz=(0.1, -0.2, 0.5), rpy=(0.3, 0.0, 0.2))
    assert tr.link_names == jr.link_names and tr.joint_names == jr.joint_names
    assert tr.urdf.get_root() == "world"
    for q, qd, qdd in _states(2, count=2, seed=7):
        got = np_(tr.rnea(t64(q), t64(qd), t64(qdd)))
        want = np.asarray(jr.rnea(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(qdd)))
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(np_(tr.fk_all(t64(q))), np.asarray(jr.fk_all(jnp.asarray(q))), atol=TOL)
