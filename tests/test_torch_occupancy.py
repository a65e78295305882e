"""The port's 2-D occupancy grid (fields/voxel_grid.py `OccupancyGrid2D`,
ops/interp.py `points_to_offsets_2d`, GTORobotModel's occupancy methods)
and `tf_base` on its FK point helpers, against the JAX package's, float64
on the CPU (the plain K3 in the port, the XLA distance query in JAX).

The grid's construction is host numpy in both packages and must be
bit-identical; offsets are integers and must be identical; occupied cells
are identical wherever no cell's distance lies within rounding of epsilon
(the test counts those cells and expects none); FK points agree to 1e-12
m. Seconds on a CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grasptrajopt_tpu.fields.voxel_grid import OccupancyGrid2D as JaxGrid
from grasptrajopt_tpu.ops.interp import points_to_offsets_2d as jax_offsets_2d
from grasptrajopt_tpu_torch.convert import occupancy_from_numpy
from grasptrajopt_tpu_torch.fields.voxel_grid import OccupancyGrid2D as PortGrid
from grasptrajopt_tpu_torch.ops.interp import points_to_offsets_2d
from torch_parity import make_jax_synth_robot, mobile_tabletop_cloud, np_, port_robot, t64

EPSILON = 0.02  # setup_occupancy_grid's default
NEAR_EPS = 1e-9  # m: a cell this close to epsilon could flip on rounding


@pytest.fixture(scope="module")
def robots():
    jr = make_jax_synth_robot(points_per_link=10)
    return jr, port_robot(jr)


@pytest.fixture(scope="module")
def tabletop_cloud():
    return mobile_tabletop_cloud(48)


@pytest.mark.parametrize("margin,resolution", [(0.4, 0.05), (0.4, 0.025), (0.1, 0.07)])
def test_grid_construction_bit_identical(margin, resolution):
    rng = np.random.default_rng(3)
    xys = rng.uniform([0.2, -0.7], [1.4, 0.6], size=(500, 2))
    a = JaxGrid.from_points_bounds(xys, margin=margin, resolution=resolution)
    b = PortGrid.from_points_bounds(xys, margin=margin, resolution=resolution)
    assert (a.origin, a.shape, a.resolution, a.size) == (b.origin, b.shape, b.resolution, b.size)
    for dtype in (np.float32, np.float64):
        ga, gb = a.grid_points(dtype), b.grid_points(dtype)
        assert ga.dtype == gb.dtype
        np.testing.assert_array_equal(ga, gb)


def test_offsets_identical_outside_and_on_cell_edges():
    """Offsets of random points (a third outside the grid on every side),
    of every cell corner (on the cell edges: floor picks the cell above)
    and of corners nudged by +-1e-12 m."""
    grid = PortGrid(origin=(-0.45, -0.8), shape=(33, 41), resolution=0.05)
    rng = np.random.default_rng(5)
    inside = rng.uniform([-0.45, -0.8], [1.2, 1.25], size=(400, 2))
    outside = rng.uniform([-3.0, -3.0], [3.0, 3.0], size=(400, 2))
    corners = grid.grid_points(np.float64)
    pts = np.concatenate([inside, outside, corners, corners + 1e-12, corners - 1e-12])
    want = np.asarray(jax_offsets_2d(jnp.asarray(pts), jnp.asarray(grid.origin), grid.shape, grid.resolution))
    got = points_to_offsets_2d(t64(pts), t64(grid.origin), grid.shape, grid.resolution)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(np_(got), want)
    np.testing.assert_array_equal(np_(grid.offsets(t64(pts))), want)
    assert (np_(got) >= 0).all() and (np_(got) < grid.size).all()


def test_setup_occupancy_grid_identical_cells(robots, tabletop_cloud):
    jr, pr = robots
    jr.setup_occupancy_grid(tabletop_cloud)
    pr.setup_occupancy_grid(tabletop_cloud)
    assert (jr.occupancy.origin, jr.occupancy.shape, jr.occupancy.resolution) == (
        pr.occupancy.origin, pr.occupancy.shape, pr.occupancy.resolution
    )
    assert pr.occupancy_grid_shape == jr.occupancy_grid_shape
    assert pr.occupancy_grid_size == jr.occupancy_grid_size
    np.testing.assert_array_equal(pr.occupancy_grid_origin, jr.occupancy_grid_origin)
    # cells whose exact distance lies within rounding of epsilon: none
    xy = tabletop_cloud[tabletop_cloud[:, 2] > 0.01][:, :2]
    gp = pr.occupancy.grid_points().astype(np.float64)
    d = np.sqrt(np.min(((gp[:, None, :] - xy[None]) ** 2).sum(-1), axis=1))
    assert int((np.abs(d - EPSILON) < NEAR_EPS).sum()) == 0
    got, want = np_(pr.occupancy_grid), np.asarray(jr.occupancy_grid)
    assert pr.occupancy_grid.dtype == torch.float64 and got.shape == want.shape == (pr.occupancy.size,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, (d < EPSILON).astype(np.float64))
    assert 0 < got.sum() < got.size


def test_occupancy_offsets_and_cost_match(robots, tabletop_cloud):
    """points_to_offsets_occupancy(_numpy), and occupancy_cost (the
    occupied-cell count under the body points) at several configurations
    and base poses, on the JAX robot's grid carried across."""
    from grasptrajopt_tpu.testing import SYNTH_DEFAULT_POSE
    from grasptrajopt_tpu_torch.planning.utils import rotZ

    jr, pr = robots
    jr.setup_occupancy_grid(tabletop_cloud)
    pr.occupancy = pr.occupancy_grid = None
    occupancy_from_numpy(pr, jr.occupancy.origin, jr.occupancy.shape, jr.occupancy.resolution,
                         np.asarray(jr.occupancy_grid))
    pts = np.random.default_rng(8).uniform(-1.0, 2.0, size=(300, 3))
    np.testing.assert_array_equal(pr.points_to_offsets_occupancy_numpy(pts),
                                  jr.points_to_offsets_occupancy_numpy(pts))
    rng = np.random.default_rng(2)
    lo, hi = jr.lower_actuated_joint_limits, jr.upper_actuated_joint_limits
    qs = [np.zeros(jr.ndof), SYNTH_DEFAULT_POSE] + [rng.uniform(lo, hi) for _ in range(3)]
    counts = []
    # the robot placed at (x, y, yaw) in the grid's frame: at the parked
    # base, beside the table, and on it (its centre is near (1.62, 0.19))
    for x, y, yaw in ((0.0, 0.0, 0.0), (-0.5, 0.3, 2.0), (1.3, 0.0, 0.5), (1.6, 0.2, 0.0)):
        tf_base_inv = rotZ(yaw)
        tf_base_inv[:2, 3] = [x, y]
        for q in qs:
            want = float(jr.occupancy_cost(jnp.asarray(q), jnp.asarray(tf_base_inv), jr.occupancy_grid))
            got = pr.occupancy_cost(q, tf_base_inv, pr.occupancy_grid)
            assert got.dtype == torch.float64 and float(got) == want
            counts.append(want)
        # a batch of configurations at once
        batch = pr.occupancy_cost(np.stack(qs), tf_base_inv, pr.occupancy_grid)
        assert np_(batch).tolist() == counts[-len(qs):]
    assert max(counts) > 0 and min(counts) == 0


def test_occupancy_from_numpy_checks_the_size(robots):
    _, pr = robots
    with pytest.raises(ValueError, match="cells"):
        occupancy_from_numpy(pr, (0.0, 0.0), (4, 5), 0.05, np.zeros(21))


@pytest.mark.parametrize("batched", [False, True])
def test_fk_surface_points_with_tf_base(robots, batched):
    from grasptrajopt_tpu_torch.planning.utils import rotZ

    jr, pr = robots
    rng = np.random.default_rng(4)
    lo, hi = jr.lower_actuated_joint_limits, jr.upper_actuated_joint_limits
    q = rng.uniform(lo, hi, size=(3, jr.ndof) if batched else (jr.ndof,))
    tf = rotZ(0.7)
    tf[:3, 3] = [0.3, -0.2, 0.1]
    base = np.array([0.05, 0.0, 0.7])
    want = np.asarray(jr.fk_surface_points(jnp.asarray(q), tf_base=jnp.asarray(tf), base_position=jnp.asarray(base)))
    got = np_(pr.fk_surface_points(t64(q), t64(base), tf_base=tf))
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    if not batched:
        want_np, _ = jr.compute_fk_surface_points(jnp.asarray(q), tf_base=tf)
        np.testing.assert_allclose(pr.compute_fk_surface_points(q, tf_base=tf), want_np, atol=1e-12, rtol=0)
        np.testing.assert_allclose(pr.compute_fk_surface_points(q), jr.compute_fk_surface_points(jnp.asarray(q))[0],
                                   atol=1e-12, rtol=0)
