"""Kinematics and the robot surface model: the port against the JAX package
at random configurations, float64 on the CPU, to 1e-12."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grasptrajopt_tpu.spatial import invt as jax_invt
from grasptrajopt_tpu.spatial import r2quat as jax_r2quat
from grasptrajopt_tpu.spatial import transform_points as jax_tp
from grasptrajopt_tpu.spatial.quaternion import qangle_deg as jax_qangle
from grasptrajopt_tpu_torch.spatial import invt, qangle_deg, r2quat, transform_points
from grasptrajopt_tpu_torch.testing import make_synthetic_gto_robot
from torch_parity import make_jax_synth_robot, np_, port_robot, t64

TOL = 1e-12
RNG = np.random.default_rng(7)


@pytest.fixture(scope="module")
def robots():
    jr = make_jax_synth_robot(points_per_link=10)
    return jr, port_robot(jr)


def _q(n=6):
    return RNG.uniform(-1.5, 1.5, size=(n, 9))


def test_fk_all_and_link_transform(robots):
    jr, pr = robots
    q = _q()
    np.testing.assert_allclose(np_(pr.fk_all(t64(q))), np.asarray(jr.fk_all(q)), atol=TOL)
    np.testing.assert_allclose(
        np_(pr.get_global_link_transform("hand", t64(q))),
        np.asarray(jr.get_global_link_transform("hand", q)), atol=TOL,
    )


def test_frame_matrix_of_components(robots):
    jr, pr = robots
    q = _q()
    cj, cp = jr.fk_components(q), pr.fk_components(t64(q))
    for f in range(len(pr.link_names)):
        np.testing.assert_allclose(
            np_(pr.frame_matrix(cp, f)), np.asarray(jr.frame_matrix(cj, f)), atol=TOL
        )


def test_fk_surface_points(robots):
    jr, pr = robots
    q = _q()
    base = np.array([0.05, 0.0, 0.7])
    np.testing.assert_allclose(
        np_(pr.fk_surface_points(t64(q), base_position=t64(base))),
        np.asarray(jr.fk_surface_points(q, base_position=base)), atol=TOL,
    )


@pytest.mark.parametrize("stride", [1, 2])
def test_surface_points_soa(robots, stride):
    jr, pr = robots
    q = _q().reshape(2, 3, 9)
    base = np.array([0.05, 0.0, 0.7])
    want = jr.surface_points_soa(jr.fk_components(q), base_position=base, stride=stride)
    got = pr.surface_points_soa(pr.fk_components(t64(q)), t64(base), stride=stride)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_allclose(np_(g), np.asarray(w), atol=TOL)


def test_assemble_extract_and_limits(robots):
    jr, pr = robots
    q = _q()
    q_opt, q_par = q[:, :7], q[:, 7:]
    np.testing.assert_array_equal(
        np_(pr.assemble_q(t64(q_opt), t64(q_par))),
        np.asarray(jnp.stack([jr.assemble_q(a, b) for a, b in zip(q_opt, q_par)])),
    )
    np.testing.assert_array_equal(np_(pr.extract_optimized_dimensions(t64(q))), q_opt)
    np.testing.assert_array_equal(np_(pr.extract_parameter_dimensions(t64(q))), q_par)
    for attr in ("lower", "upper", "velocity"):
        name = f"{attr}_optimized_joint_limits"
        np.testing.assert_array_equal(getattr(pr, name), getattr(jr, name))
    assert pr.optimized_joint_indexes == jr.optimized_joint_indexes
    assert pr.parameter_joint_indexes == jr.parameter_joint_indexes


def test_port_built_from_urdf_equals_port_built_from_jax_state(robots):
    """The port's own URDF path and the convert path agree."""
    _, pr = robots
    own = make_synthetic_gto_robot(device="cpu", dtype=torch.float64, points_per_link=10)
    q = t64(_q())
    np.testing.assert_array_equal(np_(own.fk_all(q)), np_(pr.fk_all(q)))
    for a, b in zip(own.surface_points_soa(own.fk_components(q)),
                    pr.surface_points_soa(pr.fk_components(q))):
        np.testing.assert_array_equal(np_(a), np_(b))


def test_spatial_primitives():
    jr = make_jax_synth_robot(points_per_link=10)
    T = np.asarray(jr.fk_all(_q(8)))[:, 7]  # (8, 4, 4) hand frames
    pts = RNG.normal(size=(8, 5, 3))
    np.testing.assert_allclose(np_(invt(t64(T))), np.asarray(jax_invt(T)), atol=TOL)
    np.testing.assert_allclose(
        np_(transform_points(t64(T), t64(pts))), np.asarray(jax_tp(T, pts)), atol=TOL
    )
    R = T[:, :3, :3]
    np.testing.assert_allclose(np_(r2quat(t64(R))), np.asarray(jax_r2quat(R)), atol=TOL)
    qa, qb = np.asarray(jax_r2quat(R)), np.asarray(jax_r2quat(R[::-1]))
    np.testing.assert_allclose(
        np_(qangle_deg(t64(qa), t64(qb))), np.asarray(jax_qangle(qa, qb)), atol=1e-9
    )
