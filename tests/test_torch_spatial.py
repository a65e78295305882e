"""The port's spatial functions against the JAX package's, float64, on the
same numpy inputs with leading batch axes: the rotations about x / y / z,
rpy2r and r2rpy (also at the pitch singularity), tr2rt,
transform_directions, qmul, qconj, quat2r and rotation_angle_deg, to
1e-12."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import grasptrajopt_tpu.spatial as jsp
import grasptrajopt_tpu_torch.spatial as psp
from torch_parity import np_, t64

TOL = 1e-12
RNG = np.random.default_rng(21)
ANGLES = RNG.uniform(-np.pi, np.pi, size=(3, 5))
RPY = np.concatenate([
    RNG.uniform([-np.pi, -1.4, -np.pi], [np.pi, 1.4, np.pi], size=(6, 3)),
    [[0.3, np.pi / 2, -0.4], [-1.1, -np.pi / 2, 0.7]],  # the pitch singularity
])
QUATS = RNG.normal(size=(2, 4, 4))


def _rotations():
    return np.asarray(jsp.rpy2r(jnp.asarray(RNG.uniform(-np.pi, np.pi, size=(4, 3)))))


def _transforms(lead=(2, 3)):
    T = np.tile(np.eye(4), lead + (1, 1))
    T[..., :3, :3] = np.asarray(jsp.rpy2r(jnp.asarray(RNG.uniform(-np.pi, np.pi, size=lead + (3,)))))
    T[..., :3, 3] = RNG.normal(size=lead + (3,))
    return T


def _close(got, want):
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["rotx", "roty", "rotz"])
def test_axis_rotations(name):
    _close(getattr(psp, name)(t64(ANGLES)), getattr(jsp, name)(jnp.asarray(ANGLES)))


def test_rpy_round_trip():
    _close(psp.rpy2r(t64(RPY)), jsp.rpy2r(jnp.asarray(RPY)))
    R = np.asarray(jsp.rpy2r(jnp.asarray(RPY)))
    _close(psp.r2rpy(t64(R)), jsp.r2rpy(jnp.asarray(R)))
    # away from the singularity r2rpy inverts rpy2r
    np.testing.assert_allclose(np_(psp.r2rpy(psp.rpy2r(t64(RPY[:6])))), RPY[:6], atol=1e-12)


def test_tr2rt_and_transform_directions():
    T = _transforms()
    R, t = psp.tr2rt(t64(T))
    Rj, tj = jsp.tr2rt(jnp.asarray(T))
    _close(R, Rj)
    _close(t, tj)
    dirs = RNG.normal(size=(2, 3, 7, 3))
    _close(psp.transform_directions(t64(T), t64(dirs)), jsp.transform_directions(jnp.asarray(T), jnp.asarray(dirs)))


def test_quaternion_algebra():
    a, b = QUATS[0], QUATS[1]
    _close(psp.qmul(t64(a), t64(b)), jsp.qmul(jnp.asarray(a), jnp.asarray(b)))
    _close(psp.qconj(t64(a)), jsp.qconj(jnp.asarray(a)))
    _close(psp.quat2r(t64(a)), jsp.quat2r(jnp.asarray(a)))
    # quat2r of r2quat is the identity on rotations
    R = _rotations()
    _close(psp.quat2r(psp.r2quat(t64(R))), R)


def test_rotation_angle_deg():
    Ra, Rb = _rotations(), _rotations()
    _close(psp.rotation_angle_deg(t64(Ra), t64(Rb)), jsp.rotation_angle_deg(jnp.asarray(Ra), jnp.asarray(Rb)))
    assert float(psp.rotation_angle_deg(t64(Ra[0]), t64(Ra[0]))) < 1e-5


def test_exports_cover_the_jax_package():
    assert set(jsp.__all__) <= set(psp.__all__)
    assert all(isinstance(getattr(psp, n), type(psp.rotx)) for n in jsp.__all__)
    assert psp.rotx(torch.zeros(())).dtype == torch.float32
