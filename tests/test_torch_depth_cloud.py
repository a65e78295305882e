"""DepthPointCloud and FusedDepthPointCloud of the port against the JAX
package's, float32 in both (the classes' default dtype) on rendered
observations of synthetic scene 10 at 64x64: the tabletop's nearest
object (one view) and the shelf's first object (two fused views).

Validity masks, compaction and the downsample's kept points are exact;
signed distances within 1e-6 m with identical signs; cost fields within
1e-6. The JAX class answers queries on the CPU through its C++ KD-tree
(float64 distances cast to float32), the port through K1's plain version
(float32 subtract-squares), so distances differ by float32 rounding."""

import numpy as np
import pytest
import torch

from grasptrajopt_tpu.fields import depth_point_cloud as jdpc
from grasptrajopt_tpu.fields.voxel_grid import VoxelGrid as JaxGrid
from grasptrajopt_tpu_torch.fields.depth_point_cloud import DepthPointCloud, FusedDepthPointCloud
from grasptrajopt_tpu_torch.fields.voxel_grid import VoxelGrid
from grasptrajopt_tpu_torch.ops import nn
from torch_parity import np_, observation

TOL = 1e-6


def obstacle_depth(depth, mask):
    d = np.array(depth, copy=True)
    d[mask] = 1.5
    return d


def clouds(obs, obstacle: bool):
    """(JAX cloud, port cloud) of one observation, fused over its views."""
    views = obs["depth"] if isinstance(obs["depth"], list) else [obs["depth"]]
    poses = obs["cam_pose"] if isinstance(obs["cam_pose"], list) else [obs["cam_pose"]]
    masks = obs["target_mask"] if isinstance(obs["target_mask"], list) else [obs["target_mask"]]
    jax_views, port_views = [], []
    for d, p, m in zip(views, poses, masks):
        d, m = (obstacle_depth(d, m), m) if obstacle else (d, None)
        jax_views.append(jdpc.DepthPointCloud(d, obs["K"], p, m, threshold=1.5))
        port_views.append(DepthPointCloud(d, obs["K"], p, m, threshold=1.5, device="cpu"))
    if len(views) == 1:
        return jax_views[0], port_views[0]
    return jdpc.FusedDepthPointCloud(jax_views), FusedDepthPointCloud(port_views)


@pytest.fixture(scope="module", params=["tabletop", "shelf"])
def scene(request):
    views = 2 if request.param == "shelf" else 1
    return request.param, observation(request.param, size=64, views=views)


def queries(obs, n=3_000, seed=0):
    """Points around the observed cloud: near the surface and in free
    space."""
    rng = np.random.default_rng(seed)
    base = np.asarray(obs["base_position"])
    return base + rng.uniform([0.0, -0.7, -0.4], [1.2, 0.7, 0.8], size=(n, 3))


@pytest.mark.parametrize("obstacle", [False, True])
def test_cloud_points_and_mask(scene, obstacle):
    _, obs = scene
    jc, pc = clouds(obs, obstacle)
    assert pc.points_padded.dtype == torch.float32
    np.testing.assert_array_equal(np_(pc.valid), np.asarray(jc.valid))
    np.testing.assert_allclose(pc.points, jc.points, atol=TOL, rtol=0)
    assert pc.points.shape == jc.points.shape and pc.points.shape[0] > 100


@pytest.mark.parametrize("obstacle", [False, True])
def test_get_sdf_and_visibility(scene, obstacle):
    _, obs = scene
    jc, pc = clouds(obs, obstacle)
    q = queries(obs)
    before = nn.min_d2_launches
    got = np_(pc.get_sdf(q))
    assert nn.min_d2_launches == before  # CPU tensors take the plain K1
    want = np.asarray(jc.get_sdf(q))
    np.testing.assert_array_equal(np_(pc.is_outside(q)), np.asarray(jc.is_outside(q)))
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert (got < 0).any() and (got > 0).any()
    # the shaped cost at the same queries
    np.testing.assert_allclose(np_(pc.get_sdf_cost(q)), np.asarray(jc.get_sdf_cost(q)), atol=TOL, rtol=0)


def test_downsampled_and_cost_field(scene):
    """The downsample (3 cm voxels: at 64x64 a 1 cm one keeps nearly every
    point): the same kept points, padded to a multiple of 2,048, and the
    cost field over the cloud's own bounds grid."""
    _, obs = scene
    jc, pc = clouds(obs, obstacle=True)
    jd, pd = jc.downsampled(0.03), pc.downsampled(0.03)
    assert pd.points_padded.shape == tuple(jd.points_padded.shape)
    assert pd.points_padded.shape[0] % 2048 == 0
    np.testing.assert_array_equal(np_(pd.valid), np.asarray(jd.valid))
    np.testing.assert_allclose(pd.points, jd.points, atol=TOL, rtol=0)
    assert pd.points.shape[0] < pc.points.shape[0]
    assert type(pd) is type(pc)  # a fused view keeps every view's sign test

    grid = VoxelGrid.from_points(pc.points, resolution=0.1)
    jgrid = JaxGrid.from_points(jc.points, resolution=0.1)
    assert (grid.origin, grid.shape, grid.resolution) == (jgrid.origin, jgrid.shape, jgrid.resolution)
    for j, p in ((jc, pc), (jd, pd)):
        got = np_(p.build_cost_field(grid, epsilon=0.02))
        want = np.asarray(j.build_cost_field(jgrid, epsilon=0.02))
        assert got.shape == (grid.size,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        assert want.max() > 0.0
