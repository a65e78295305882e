"""Depth-camera scene clouds and the planner's two cost fields, batch-first.

Port of grasptrajopt_tpu/fields/depth_point_cloud.py:31-163:
  - backprojection with (0 < depth < threshold) validity;
  - signed distance = nearest-point distance, negative where the query is
    NOT observed free space by the camera (`camera_outside`);
  - the planner's eps-band obstacle shaping
        cost = w_inside * (-d + eps/2)   d <= 0
               (d - eps)^2 / (2 eps)    0 < d < eps
               0                        d >= eps
  - `build_two_cost_fields`: both fields of a batch of observations, the
    distance passes each ONE K1 launch over all B clouds;
  - `DepthPointCloud` / `FusedDepthPointCloud` (JAX :166-375): one
    observation (or the union of several) with signed-distance queries,
    each `get_sdf` one K1 launch over the masked H*W cloud, as the
    pipeline's fields, grasp filter and replay scorer use them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from grasptrajopt_tpu_torch.ops.dedup import voxel_dedup
from grasptrajopt_tpu_torch.ops.nn import min_sqdist_d2


def backproject_depth(depth, intrinsic_matrix, camera_pose):
    """Depth images (B, H, W) -> world points (B, H*W, 3)."""
    B, H, W = depth.shape
    dt, dev = depth.dtype, depth.device
    K_inv = torch.linalg.inv(intrinsic_matrix.to(dt))
    y, x = torch.meshgrid(
        torch.arange(H, dtype=dt, device=dev), torch.arange(W, dtype=dt, device=dev),
        indexing="ij",
    )
    pix = torch.stack([x, y, torch.ones_like(x)], dim=-1).reshape(-1, 3)  # (H*W, 3)
    rays = pix @ K_inv.T
    pts_cam = rays * depth.reshape(B, -1, 1)
    R = camera_pose[..., :3, :3].to(dt)
    t = camera_pose[..., :3, 3].to(dt)
    return pts_cam @ R.transpose(-1, -2) + t[:, None, :]


def camera_outside(depth, intrinsic_matrix, camera_pose, query_points):
    """Camera-visibility sign test: True where the query is observed free
    space — in front of the measured surface, or outside the viewport.

    depth (B, H, W); camera_pose (B, 4, 4); query_points (M, 3) shared or
    (B, M, 3). Returns (B, M) bool. Pixel coordinates truncate toward zero,
    as the JAX package's int32 cast does (points behind the camera
    included).
    """
    B, H, W = depth.shape
    dt = depth.dtype
    q = query_points.to(dt)
    R = camera_pose[..., :3, :3].to(dt)
    t = camera_pose[..., :3, 3].to(dt)
    pc = (q - t[:, None, :]) @ R  # camera frame, (B, M, 3)
    proj = pc @ intrinsic_matrix.to(dt).T
    z = proj[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-12, z, torch.full_like(z, 1e-12))
    u = (proj[..., 0] / safe_z).to(torch.int32)
    v = (proj[..., 1] / safe_z).to(torch.int32)
    in_viewport = (u >= 0) & (v >= 0) & (u < W) & (v < H)
    uc = torch.clamp(u, 0, W - 1).to(torch.long)
    vc = torch.clamp(v, 0, H - 1).to(torch.long)
    measured = torch.gather(depth.reshape(B, -1), 1, vc * W + uc)
    return torch.where(in_viewport, pc[..., 2] < measured, torch.ones_like(in_viewport))


def sdf_cost_shaping(distances, epsilon: float = 0.02, w_inside: float = 1.0):
    """The eps-band obstacle cost."""
    inside = distances <= 0.0
    band = (distances > 0.0) & (distances < epsilon)
    cost_inside = w_inside * (-distances + epsilon / 2.0)
    cost_band = torch.square(distances - epsilon) / (2.0 * epsilon)
    zero = torch.zeros_like(distances)
    return torch.where(inside, cost_inside, torch.where(band, cost_band, zero))


def sdf_cost_shaping_deriv(distances, epsilon: float = 0.02, w_inside: float = 1.0):
    """d(sdf_cost_shaping)/d(distance)."""
    inside = distances <= 0.0
    band = (distances > 0.0) & (distances < epsilon)
    d_inside = torch.full_like(distances, -w_inside)
    d_band = (distances - epsilon) / epsilon
    zero = torch.zeros_like(distances)
    return torch.where(inside, d_inside, torch.where(band, d_band, zero))


def signed_distance_to_cloud(query_points, cloud_pts, cloud_mask, depth, K, cam_pose):
    """(B, M) signed distances of queries ((M, 3) or (B, M, 3)) to B padded
    clouds (B, N, 3) + masks (B, N), camera-visibility sign from the depth
    images. One K1 launch."""
    d = torch.sqrt(min_sqdist_d2(query_points, cloud_pts, cloud_mask))
    outside = camera_outside(depth, K, cam_pose, query_points)
    return torch.where(outside, d, -d)


def first_true_indices(mask, size: int):
    """Static-shape `nonzero`: per row of mask (B, N), the indices of the
    first `size` True entries in order, padded with 0 — `jnp.nonzero(m,
    size=size, fill_value=0)` without a host sync."""
    B, N = mask.shape
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    if size > N:
        order = torch.cat([order, order.new_zeros(B, size - N)], dim=-1)
    order = order[:, :size]
    count = mask.sum(dim=-1, keepdim=True)
    keep = torch.arange(size, device=mask.device)[None, :] < count
    return torch.where(keep, order, torch.zeros_like(order)), keep


class TwoCostFields(NamedTuple):
    f_all: torch.Tensor  # (B, M) scene field
    f_obs: torch.Tensor  # (B, M) target-free obstacle field
    obs_pts: torch.Tensor  # (B, C_obs, 3) deduplicated obstacle cloud
    obs_mask: torch.Tensor  # (B, C_obs)
    tgt_pts: torch.Tensor  # (B, C_tgt, 3) target pixels' points
    tgt_mask: torch.Tensor  # (B, C_tgt)


def cost_fields_from_d2(
    d2_obs, d2_tgt, depth, intrinsic_matrix, camera_pose, target_mask, grid_pts,
    threshold: float = 1.5, epsilon: float = 0.02,
):
    """Signs + shaping of both fields from the two distance passes: the
    scene field uses min(d_obstacle, d_target) and the raw depth image; the
    obstacle field d_obstacle and the target-masked depth image."""
    d_obs = torch.sqrt(d2_obs)
    d_all = torch.sqrt(torch.minimum(d2_obs, d2_tgt))
    depth_obs = torch.where(target_mask, torch.full_like(depth, threshold), depth)
    out_all = camera_outside(depth, intrinsic_matrix, camera_pose, grid_pts)
    out_obs = camera_outside(depth_obs, intrinsic_matrix, camera_pose, grid_pts)
    f_all = sdf_cost_shaping(torch.where(out_all, d_all, -d_all), epsilon)
    f_obs = sdf_cost_shaping(torch.where(out_obs, d_obs, -d_obs), epsilon)
    return f_all, f_obs


def build_two_cost_fields(
    depth,
    intrinsic_matrix,
    camera_pose,
    target_mask,
    grid_pts,
    threshold: float = 1.5,
    epsilon: float = 0.02,
    dedup_voxel: float = 0.01,
    capacity_obstacle: int = 12288,
    capacity_target: int = 2048,
) -> TwoCostFields:
    """Both planner cost fields of B observations.

    depth (B, H, W); camera_pose (B, 4, 4); target_mask (B, H, W) bool;
    grid_pts (M, 3). The obstacle cloud (valid & ~target) is voxel-
    deduplicated and min-distanced once; the scene field reuses it with the
    small target point set (the first `capacity_target` target pixels in
    raster order; overflow pixels are dropped). Two K1 launches in all.
    """
    B = depth.shape[0]
    tmask = target_mask.reshape(B, -1)
    valid = ((depth > 0) & (depth < threshold)).reshape(B, -1)
    pts = backproject_depth(depth, intrinsic_matrix, camera_pose)
    obs_pts, obs_mask, _ = voxel_dedup(pts, valid & ~tmask, dedup_voxel, capacity_obstacle)
    t_idx, tgt_mask = first_true_indices(valid & tmask, capacity_target)
    tgt_pts = torch.gather(pts, 1, t_idx[..., None].expand(t_idx.shape + (3,)))
    q = grid_pts.to(depth.dtype)
    d2_obs = min_sqdist_d2(q, obs_pts, obs_mask)
    d2_tgt = min_sqdist_d2(q, tgt_pts, tgt_mask)
    f_all, f_obs = cost_fields_from_d2(
        d2_obs, d2_tgt, depth, intrinsic_matrix, camera_pose, target_mask, q,
        threshold, epsilon,
    )
    return TwoCostFields(f_all, f_obs, obs_pts, obs_mask, tgt_pts, tgt_mask)


class DepthPointCloud:
    """Scene point cloud of one depth image, with signed-distance queries.

    The cloud keeps the static (H*W, 3) shape with a validity mask
    (0 < depth < threshold, and off the target mask when one is given).
    float32 by default, as in the JAX package: the fields, the grasp
    filter and the replay scorer run in float32 whatever the robot's
    dtype, and K1 takes float32 only. Queries are cast to the cloud's
    dtype and device; every query returns a tensor there.
    """

    def __init__(
        self,
        depth,
        intrinsic_matrix,
        camera_pose,
        target_mask=None,
        threshold: float = 1.5,
        dtype=torch.float32,
        device="cuda",
    ):
        def tensor(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        self.depth = tensor(depth)
        self.height, self.width = self.depth.shape
        self.intrinsic_matrix = tensor(intrinsic_matrix)
        self.camera_pose = tensor(camera_pose)
        self.threshold = threshold
        valid = (self.depth > 0) & (self.depth < threshold)
        if target_mask is not None:
            valid = valid & (torch.as_tensor(np.asarray(target_mask), device=device) == 0)
        self.points_padded = backproject_depth(
            self.depth[None], self.intrinsic_matrix, self.camera_pose[None]
        )[0]
        self.valid = valid.reshape(-1)

    @property
    def dtype(self):
        return self.depth.dtype

    @property
    def device(self):
        return self.depth.device

    @property
    def points(self) -> np.ndarray:
        """Compacted (N, 3) world points, host numpy."""
        return self.points_padded[self.valid].cpu().numpy()

    def get_random_surface_points(self, count: int, generator=None, index=None) -> np.ndarray:
        """`count` cloud points drawn uniformly with replacement, host numpy
        (count, 3): the draw comes from `generator` (a CPU torch.Generator)
        or is given as `index` (count,) into `points`."""
        pts = self.points
        if index is None:
            index = torch.randint(0, pts.shape[0], (count,), generator=generator).numpy()
        return pts[np.asarray(index)]

    def _queries(self, query_points):
        return torch.as_tensor(query_points, dtype=self.dtype, device=self.device)

    def is_outside(self, query_points):
        """(M,) bool: True where the query is observed free space (in
        front of the measured surface, or outside the viewport)."""
        q = self._queries(query_points)
        return camera_outside(self.depth[None], self.intrinsic_matrix, self.camera_pose[None], q)[0]

    def get_sdf(self, query_points):
        """(M,) signed distances of (M, 3) world points to the cloud:
        negative where the query is not observed free space. One K1
        launch on the card."""
        q = self._queries(query_points)
        d = torch.sqrt(min_sqdist_d2(q, self.points_padded[None], self.valid[None])[0])
        return torch.where(self.is_outside(q), d, -d)

    def get_sdf_in_batches(self, query_points, batch_size: int = 1_000_000):
        """get_sdf over consecutive chunks of `batch_size` queries (one K1
        launch each on the card), concatenated."""
        q = self._queries(query_points)
        return torch.cat([self.get_sdf(c) for c in torch.split(q, batch_size)]) if len(q) else self.get_sdf(q)

    def get_sdf_cost(self, query_points, epsilon: float = 0.02, w_inside: float = 1.0):
        """The shaped obstacle cost at query points (the planner's field
        values)."""
        return sdf_cost_shaping(self.get_sdf(query_points), epsilon, w_inside)

    def build_cost_field(self, grid, epsilon: float = 0.02, w_inside: float = 1.0):
        """The flat (S,) cost field over a VoxelGrid's points."""
        return self.get_sdf_cost(grid.grid_points(), epsilon=epsilon, w_inside=w_inside)

    def _with_cloud(self, points_padded, valid):
        """A copy that shares this view's camera and sign test but queries
        another cloud."""
        view = object.__new__(type(self))
        view.__dict__.update(self.__dict__)
        view.points_padded, view.valid = points_padded, valid
        return view

    def downsampled(self, voxel: float, capacity_step: int = 2048):
        """A query-equivalent view with one cloud point per `voxel`-sized
        cell (the first in raster order; distance error <= voxel / 2 at
        worst), padded to a multiple of `capacity_step`. Host numpy, as in
        the JAX package. Used by the fine-grid shelf field builds."""
        pts = self.points
        if voxel and voxel > 0 and pts.shape[0] > 0:
            cells = np.floor(pts / voxel).astype(np.int64)
            _, keep = np.unique(cells, axis=0, return_index=True)
            pts = pts[np.sort(keep)]
        n = max(int(pts.shape[0]), 1)
        cap = -(-n // capacity_step) * capacity_step
        padded = np.zeros((cap, 3), dtype=pts.dtype)
        padded[:n] = pts[:n]
        valid = np.arange(cap) < n
        return self._with_cloud(
            torch.as_tensor(padded, device=self.device), torch.as_tensor(valid, device=self.device)
        )


class FusedDepthPointCloud(DepthPointCloud):
    """The union of several views' observations: the points of every
    view's cloud (one K1 launch over all of them), and a query is outside
    when ANY view observes it in front of its measured surface."""

    def __init__(self, views):
        views = list(views)
        if not views:
            raise ValueError("FusedDepthPointCloud needs at least one view")
        self.__dict__.update(views[0].__dict__)
        self.views = views
        self.points_padded = torch.cat([v.points_padded for v in views])
        self.valid = torch.cat([v.valid for v in views])

    def is_outside(self, query_points):
        out = self.views[0].is_outside(query_points)
        for v in self.views[1:]:
            out = out | v.is_outside(query_points)
        return out
