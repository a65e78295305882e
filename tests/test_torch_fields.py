"""Perception and field modules of the port against the JAX package: the
plain K1 against the Pallas kernel in interpret mode, the batch-first
min-distance entry, voxel dedup, the two cost fields of a rendered scene,
and the packed trilinear lookups."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grasptrajopt_tpu.envs.synthetic import SyntheticSceneEnv
from grasptrajopt_tpu.fields import depth_point_cloud as jdpc
from grasptrajopt_tpu.fields.voxel_grid import VoxelGrid as JaxGrid
from grasptrajopt_tpu.ops import interp as jinterp
from grasptrajopt_tpu.ops import nn as jnn
from grasptrajopt_tpu.ops import voxel_dedup as jax_dedup
from grasptrajopt_tpu_torch.fields import depth_point_cloud as pdpc
from grasptrajopt_tpu_torch.fields.voxel_grid import VoxelGrid as PortGrid
from grasptrajopt_tpu_torch.ops import interp as pinterp
from grasptrajopt_tpu_torch.ops import nn as pnn
from grasptrajopt_tpu_torch.ops.dedup import voxel_dedup as port_dedup
from torch_parity import np_, t64

RNG = np.random.default_rng(3)


def _k1_inputs(B=3, M=100, N=300):
    q = RNG.normal(size=(M, 3)).astype(np.float32)
    r = RNG.normal(size=(B, N, 3)).astype(np.float32)
    mask = RNG.uniform(size=(B, N)) > 0.2
    mask[:, 0] = True
    return q, r, mask


def test_plain_k1_matches_pallas_interpret():
    """min_d2_batched_reference vs min_d2_batched_pallas (interpret mode,
    f32, tm=64, tn=128): both are exact-f32 subtract-square forms; 1e-6."""
    from jax.experimental.pallas import tpu as pltpu

    q, r, mask = _k1_inputs()
    M = q.shape[0]
    q8 = jnn._pack_query8(jnp.asarray(q), tm=64)
    rT = jnn._pack_refT(jnp.asarray(r), jnp.asarray(mask), tn=128)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jnn.min_d2_batched_pallas(q8, rT, tm=64, tn=128))[:, :M]
    rT_port = pnn._pack_refT(torch.from_numpy(r), torch.from_numpy(mask))
    got = pnn.min_d2_batched_reference(torch.from_numpy(q), rT_port)
    np.testing.assert_allclose(np_(got), want, atol=1e-6, rtol=0)
    # the public wrapper takes the plain path for CPU tensors, counting nothing
    before = pnn.min_d2_launches
    np.testing.assert_array_equal(np_(pnn.min_d2_batched(torch.from_numpy(q), rT_port)), np_(got))
    assert pnn.min_d2_launches == before
    # per-cloud queries: cloud b's queries give cloud b's shared-query rows
    qb = torch.from_numpy(np.stack([q, q[::-1], q + 0.5]))
    per = pnn.min_d2_batched_reference(qb, rT_port)
    for b in range(3):
        shared = pnn.min_d2_batched_reference(qb[b], rT_port)[b]
        np.testing.assert_array_equal(np_(per[b]), np_(shared))


def test_min_sqdist_d2_matches_jax_fallback_f64():
    q, r, mask = _k1_inputs(B=2, M=70, N=90)
    q, r = q.astype(np.float64), r.astype(np.float64)
    got = pnn.min_sqdist_d2(t64(q), t64(r), torch.from_numpy(mask))
    for b in range(2):
        want = jnn.min_sqdist_d2(jnp.asarray(q), jnp.asarray(r[b]), jnp.asarray(mask[b]), use_pallas=False)
        np.testing.assert_allclose(np_(got[b]), np.asarray(want), atol=1e-12, rtol=0)


def test_voxel_dedup_bit_identical():
    """Kept points, mask and count match exactly, including the int32
    wrap of the cell-id hash (ids up to 2^30 overflow the multiply)."""
    pts = np.concatenate(
        [RNG.uniform(-1, 1, size=(2, 3000, 3)), RNG.uniform(0, 9, size=(2, 1000, 3))], axis=1
    ).astype(np.float32)
    pts[:, 4000 - 50:] = pts[:, :50]  # duplicates: the first occurrence must win
    valid = RNG.uniform(size=(2, 4000)) > 0.1
    for voxel, cap in ((0.05, 8192), (0.05, 1500), (0.01, 2048)):
        got = port_dedup(torch.from_numpy(pts), torch.from_numpy(valid), voxel, cap)
        for b in range(2):
            want = jax.jit(lambda p, v: jax_dedup(p, v, voxel, cap))(
                jnp.asarray(pts[b]), jnp.asarray(valid[b])
            )
            np.testing.assert_array_equal(np_(got[0][b]), np.asarray(want[0]))
            np.testing.assert_array_equal(np_(got[1][b]), np.asarray(want[1]))
            assert int(got[2][b]) == int(want[2])


def test_int32_hash_wraps_like_jax():
    cid = np.array([0, 1, 2**20 + 5, 2**29 + 12345, 2**30 - 1], np.int32)
    mult = np.int32(np.uint32(0x9E3779B1))
    want = np.asarray((jnp.asarray(cid) * jnp.int32(mult)) & jnp.int32(0x7FFFFFFF))
    got = (torch.from_numpy(cid) * torch.tensor(int(mult), dtype=torch.int32)) & 0x7FFFFFFF
    np.testing.assert_array_equal(np_(got), want)


@pytest.mark.parametrize("size", [40, 300])
def test_first_true_indices_matches_static_nonzero(size):
    """The target compaction keeps the first `size` True entries in raster
    order and drops the overflow (size 40), or pads with index 0 (size 300
    > N), exactly as jnp.nonzero(m, size=size, fill_value=0)."""
    mask = RNG.uniform(size=(3, 200)) > 0.6
    idx, keep = pdpc.first_true_indices(torch.from_numpy(mask), size)
    for b in range(3):
        want = np.asarray(jnp.nonzero(jnp.asarray(mask[b]), size=size, fill_value=0)[0])
        np.testing.assert_array_equal(np_(idx[b]), want)
        np.testing.assert_array_equal(np_(keep[b]), np.arange(size) < mask[b].sum())


@pytest.fixture(scope="module")
def scene():
    env = SyntheticSceneEnv(robot_name="panda", scene_type="tabletop", n_objects=5, width=64, height=64)
    meta = env.setup_scene(36)
    depths, masks, poses = [], [], []
    for name in meta["nearest_first"].split(",")[:2]:
        depth, ids, pose, K = env.get_observation()
        depths.append(depth.astype(np.float64))
        masks.append(ids == env._placed(name).uid)
        poses.append(pose)
        env.remove_object(name)
    grid = JaxGrid(origin=(0.3, -0.4, 0.6), shape=(12, 12, 16), resolution=0.05)
    return np.stack(depths), np.stack(masks), np.stack(poses), np.asarray(K, np.float64), grid


def test_camera_outside_and_backprojection(scene):
    depth, mask, pose, K, _ = scene
    q = np.concatenate(
        [RNG.uniform([0.2, -0.5, 0.5], [1.0, 0.5, 1.4], size=(400, 3)),
         pose[0, :3, 3] - RNG.uniform(0.05, 1.0, size=(100, 1)) * pose[0, :3, 2]],  # behind the camera
        axis=0,
    )
    got_out = pdpc.camera_outside(t64(depth), t64(K), t64(pose), t64(q))
    got_pts = pdpc.backproject_depth(t64(depth), t64(K), t64(pose))
    for b in range(2):
        want_out = jdpc.camera_outside(depth[b], K, pose[b], q)
        np.testing.assert_array_equal(np_(got_out[b]), np.asarray(want_out))
        want_pts, _ = jdpc.backproject_depth(depth[b], K, pose[b], np.ones(depth[b].shape, bool))
        np.testing.assert_allclose(np_(got_pts[b]), np.asarray(want_pts), atol=1e-12)
    d = RNG.uniform(-0.05, 0.05, size=200)
    for fp, fj in ((pdpc.sdf_cost_shaping, jdpc.sdf_cost_shaping),
                   (pdpc.sdf_cost_shaping_deriv, jdpc.sdf_cost_shaping_deriv)):
        np.testing.assert_allclose(np_(fp(t64(d), 0.02)), np.asarray(fj(d, 0.02)), atol=1e-15)


def test_build_two_cost_fields_f64(scene):
    """Both fields of two rendered observations (64x64, a 12x12x16 grid,
    capacities 4096/512), float64, to 1e-10; dedup output exactly."""
    depth, mask, pose, K, grid = scene
    gp = grid.grid_points(np.float64)
    got = pdpc.build_two_cost_fields(
        t64(depth), t64(K), t64(pose), torch.from_numpy(mask), t64(gp),
        capacity_obstacle=4096, capacity_target=512,
    )
    for b in range(2):
        f_all, f_obs, obs_pts, obs_mask = jdpc.build_two_cost_fields(
            jnp.asarray(depth[b]), jnp.asarray(K), jnp.asarray(pose[b]), jnp.asarray(mask[b]),
            jnp.asarray(gp), capacity_obstacle=4096, capacity_target=512,
        )
        np.testing.assert_array_equal(np_(got.obs_mask[b]), np.asarray(obs_mask))
        np.testing.assert_allclose(np_(got.obs_pts[b]), np.asarray(obs_pts), atol=1e-12)
        np.testing.assert_allclose(np_(got.f_all[b]), np.asarray(f_all), atol=1e-10, rtol=0)
        np.testing.assert_allclose(np_(got.f_obs[b]), np.asarray(f_obs), atol=1e-10, rtol=0)
        assert np.asarray(f_obs).max() > 0.0  # the scene reaches into the grid


def test_pack_and_packed_lookups():
    """pack_corners and the packed SoA lookups (value + closed-form
    gradient), at points inside and outside the grid, to 1e-12."""
    jg = JaxGrid(origin=(-0.2, -0.3, 0.1), shape=(6, 7, 5), resolution=0.05)
    pg = PortGrid(jg.origin, jg.shape, jg.resolution)
    fields = RNG.uniform(0, 0.1, size=(2, jg.size))
    packed_p = pg.pack(t64(fields))  # (2, S, 8)
    for b in range(2):
        np.testing.assert_array_equal(np_(packed_p[b]), np.asarray(jg.pack(jnp.asarray(fields[b]))))
    table = packed_p.reshape(-1, 8)
    pts = RNG.uniform([-0.4, -0.5, -0.1], [0.3, 0.2, 0.4], size=(2, 50, 3))  # some outside
    origin = np.asarray(jg.origin)
    x, y, z = (pts[..., i] for i in range(3))
    base = np.array([0, jg.size])[:, None]
    want = jinterp.field_lookup_packed_soa_grad(
        jnp.asarray(table), jnp.asarray(x), jnp.asarray(y), jnp.asarray(z),
        jnp.asarray(origin), jg.shape, jg.resolution, row_offset=jnp.asarray(base),
    )
    got = pinterp.field_lookup_packed_soa_grad(
        table, t64(x), t64(y), t64(z), t64(origin), jg.shape, jg.resolution,
        row_offset=torch.as_tensor(base),
    )
    for w, g in zip(want, got):
        np.testing.assert_allclose(np_(g), np.asarray(w), atol=1e-12)
    val = pinterp.field_lookup_trilinear_packed_soa(
        table, t64(x), t64(y), t64(z), t64(origin), jg.shape, jg.resolution,
        row_offset=torch.as_tensor(base),
    )
    np.testing.assert_allclose(np_(val), np.asarray(want[0]), atol=1e-12)
    np.testing.assert_array_equal(
        np_(pg.lookup_nearest(t64(fields[0]), t64(pts[0]))),
        np.asarray(jg.lookup_nearest(jnp.asarray(fields[0]), jnp.asarray(pts[0]))),
    )
