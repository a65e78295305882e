"""The robot model's and the depth cloud's helpers against the JAX
package's, float64, on the synthetic arm (10 points per link) at random
configurations: link transforms (global and relative, and their column
functions), positions, rotations, quaternions, RPY angles, the geometric,
linear, angular and analytical Jacobians (revolute and prismatic joints),
link axes, random configurations (the JAX draw injected), one link's
surface points, the grid offsets and compute_plan_cost; DepthPointCloud's
random surface points (the JAX draw injected) and batched signed
distances. To 1e-10."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grasptrajopt_tpu.fields.depth_point_cloud import DepthPointCloud as JaxCloud
from grasptrajopt_tpu.testing import SYNTH_DEFAULT_POSE
from grasptrajopt_tpu_torch.fields.depth_point_cloud import DepthPointCloud
from torch_parity import make_jax_synth_robot, np_, observation, port_robot, t64

TOL = 1e-10
RNG = np.random.default_rng(17)
LINKS = ["hand", "l3", "finger_l"]


@pytest.fixture(scope="module")
def robots():
    jr = make_jax_synth_robot(points_per_link=10, grid_resolution=0.1)
    return jr, port_robot(jr)


def _configs(n=4):
    q = np.tile(SYNTH_DEFAULT_POSE.astype(np.float64), (n, 1))
    q[:, :7] += RNG.normal(scale=0.5, size=(n, 7))
    q[:, 7:] = RNG.uniform(0.0, 0.04, size=(n, 2))
    return q


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=tol, rtol=0)


@pytest.mark.parametrize("link", LINKS)
def test_link_poses(robots, link):
    jr, pr = robots
    q = _configs()
    for name in ("position", "rotation", "quaternion", "rpy"):
        fn = f"get_global_link_{name}"
        _close(getattr(pr, fn)(link, t64(q)), getattr(jr, fn)(link, jnp.asarray(q)))
    _close(pr.get_link_transform(link, t64(q), "l1"), jr.get_link_transform(link, jnp.asarray(q), "l1"))
    for axis in "xyz":
        _close(pr.get_link_axis(link, t64(q), axis), jr.get_link_axis(link, jnp.asarray(q), axis))
    # the column-stacked functions, (ndof,) and (ndof, n)
    for port_fn, jax_fn in (
        (pr.get_global_link_transform_function(link, 4), jr.get_global_link_transform_function(link, 4)),
        (pr.get_link_transform_function(link, "l2", 4), jr.get_link_transform_function(link, "l2", 4)),
    ):
        _close(port_fn(q.T), jax_fn(q.T))
        _close(port_fn(q[0]), jax_fn(q[0]))


@pytest.mark.parametrize("link", LINKS)
def test_jacobians(robots, link):
    jr, pr = robots
    for q in _configs(2):
        for name in ("geometric", "linear", "angular_geometric", "analytical"):
            fn = f"get_global_link_{name}_jacobian"
            _close(getattr(pr, fn)(link, t64(q)), getattr(jr, fn)(link, jnp.asarray(q)))
    # batched geometric Jacobian = per-configuration ones
    q = _configs(3)
    J = pr.get_global_link_geometric_jacobian(link, t64(q))
    for i in range(3):
        _close(J[i], jr.get_global_link_geometric_jacobian(link, jnp.asarray(q[i])))


def test_random_joint_positions(robots):
    jr, pr = robots
    key = jax.random.PRNGKey(3)
    want = jr.get_random_joint_positions(key, n=5)
    u = jax.random.uniform(key, (5, jr.ndof), dtype=jnp.float64)
    _close(pr.get_random_joint_positions(None, n=5, u=t64(u)), want)
    lo, hi = -0.5 * np.ones(9), 0.25 * np.ones(9)
    _close(pr.get_random_joint_positions(None, 5, lo, hi, u=t64(u)), jr.get_random_joint_positions(key, 5, lo, hi))
    gen = torch.Generator().manual_seed(0)
    q = pr.get_random_joint_positions(gen, n=64)
    assert q.shape == (64, 9) and q.dtype == torch.float64
    lo_c = np.clip(pr.lower_actuated_joint_limits, -10, 10)
    hi_c = np.clip(pr.upper_actuated_joint_limits, -10, 10)
    assert (np_(q) >= lo_c).all() and (np_(q) <= hi_c).all()


def test_link_surface_points_offsets_and_plan_cost(robots):
    jr, pr = robots
    q = _configs(1)[0]
    tf_base = np.eye(4)
    tf_base[:3, 3] = [0.1, -0.2, 0.05]
    for link in LINKS:
        _close(pr.compute_fk_link_surface_points(q, link), jr.compute_fk_link_surface_points(jnp.asarray(q), link))
        _close(pr.compute_fk_link_surface_points(q, link, tf_base),
               jr.compute_fk_link_surface_points(jnp.asarray(q), link, tf_base))
    lo = np.asarray(jr.grid.origin) - 0.2
    hi = lo + np.asarray(jr.grid.shape) * jr.grid.resolution + 0.4
    pts = RNG.uniform(lo, hi, size=(6, 20, 3))
    np.testing.assert_array_equal(np_(pr.points_to_offsets(t64(pts))), np.asarray(jr.points_to_offsets(jnp.asarray(pts))))
    np.testing.assert_array_equal(pr.points_to_offsets_numpy(pts), jr.points_to_offsets_numpy(pts))
    z = jr.grid.grid_points(np.float64)[:, 2]
    field = np.maximum(0.0, 0.6 - z) + 0.01 * RNG.random(jr.grid.size)
    plan = np.linspace(SYNTH_DEFAULT_POSE, _configs(1)[0], 12).T  # (ndof, T)
    base = np.array([0.03, -0.01, 0.02])
    got = pr.compute_plan_cost(plan, field, base)
    want = jr.compute_plan_cost(plan, field, base)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert got[0] > 0.0  # the plan passes through the field


def test_depth_cloud_helpers():
    obs = observation("tabletop", size=32)
    args = (obs["depth"], obs["K"], obs["cam_pose"], obs["target_mask"])
    jc = JaxCloud(*args, dtype=jnp.float64)
    pc = DepthPointCloud(*args, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(pc.points, jc.points)
    want = jc.get_random_surface_points(50, seed=4)
    index = np.random.default_rng(4).choice(jc.points.shape[0], 50)
    np.testing.assert_array_equal(pc.get_random_surface_points(50, index=index), want)
    drawn = pc.get_random_surface_points(50, generator=torch.Generator().manual_seed(1))
    assert drawn.shape == (50, 3) and np.isin(drawn, pc.points).all()
    q = RNG.uniform(-0.5, 1.5, size=(700, 3))
    _close(pc.get_sdf_in_batches(q, batch_size=256), jc.get_sdf_in_batches(jnp.asarray(q)))
    _close(pc.get_sdf_in_batches(q, batch_size=256), pc.get_sdf(q), 0.0)
