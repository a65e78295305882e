"""Scene point-set preparation for the planner's points mode.

Copy of grasptrajopt_tpu/fields/scene_points.py (numpy only, so both
packages get identical arrays). `obstacle_mode='points'` computes the
eps-band cost directly from the exact signed distance to a
voxel-downsampled scene point set (ops.nn.signed_distance_with_dir, kernel
K2), with the sign taken from the nearest scene point's normal (the
reference's 'normal' sign method with k=1,
mesh_to_sdf/surface_point_cloud.py:32-64).

This module prepares that representation: voxel-hash downsampling of a
depth cloud to a fixed-capacity padded set, with per-point normals
estimated from the depth image's cross-tangents and oriented toward the
camera.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

PAD_COORD = 1.0e6  # padded rows sit far away and never win the min


@dataclass
class ScenePointSet:
    points: np.ndarray  # (K, 3), padded with PAD_COORD
    normals: np.ndarray  # (K, 3), padded with +z
    count: int
    # effective dedup voxel size: the requested resolution, or the coarser
    # one reached when the cloud had to be thinned to fit the capacity
    resolution: float = 0.02

    @property
    def capacity(self) -> int:
        return self.points.shape[0]


def depth_normals(depth: np.ndarray, K: np.ndarray, cam_pose: np.ndarray) -> np.ndarray:
    """Per-pixel world-frame normals from depth-image cross-tangents,
    oriented toward the camera. (H, W, 3)."""
    depth = np.asarray(depth, dtype=np.float64)
    H, W = depth.shape
    Kinv = np.linalg.inv(np.asarray(K, dtype=np.float64))
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1).astype(np.float64)
    pts_cam = (pix @ Kinv.T) * depth[..., None]
    du = np.gradient(pts_cam, axis=1)
    dv = np.gradient(pts_cam, axis=0)
    n = np.cross(du, dv)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)
    # orient toward the camera (camera at origin in camera frame)
    flip = np.sum(n * pts_cam, axis=-1, keepdims=True) > 0
    n = np.where(flip, -n, n)
    R = np.asarray(cam_pose, dtype=np.float64)[:3, :3]
    return n @ R.T


def downsample_scene(
    points: np.ndarray,
    normals: np.ndarray,
    capacity: int,
    resolution: float = 0.02,
) -> ScenePointSet:
    """Voxel-hash downsample to at most `capacity` representative points
    (first point per occupied voxel; deterministic), padded to capacity."""
    points = np.asarray(points, dtype=np.float64)
    normals = np.asarray(normals, dtype=np.float64)
    if points.shape[0] == 0:
        out_p = np.full((capacity, 3), PAD_COORD)
        out_n = np.tile(np.array([0.0, 0.0, 1.0]), (capacity, 1))
        return ScenePointSet(out_p, out_n, 0, resolution)

    def voxel_first_idx(res):
        cells = np.floor(points / res).astype(np.int64)
        # stable unique by first occurrence
        _, first_idx = np.unique(
            cells[:, 0] * 73856093 ^ cells[:, 1] * 19349663 ^ cells[:, 2] * 83492791,
            return_index=True,
        )
        return np.sort(first_idx)

    first_idx = voxel_first_idx(resolution)
    # over capacity: COARSEN the voxel size until the set fits. An index
    # subsample (every k-th surviving point in scan order) leaves gaps of
    # k voxels along the scan direction — holes wider than the sign test's
    # lateral footprint, through which penetrations go unseen; a coarser
    # uniform grid keeps coverage complete at lower density instead.
    while first_idx.shape[0] > capacity:
        resolution *= 1.3
        first_idx = voxel_first_idx(resolution)
    pts = points[first_idx]
    nrm = normals[first_idx]

    n = pts.shape[0]
    out_p = np.full((capacity, 3), PAD_COORD)
    out_n = np.tile(np.array([0.0, 0.0, 1.0]), (capacity, 1))
    out_p[:n] = pts
    out_n[:n] = nrm
    return ScenePointSet(out_p, out_n, n, resolution)


def _view_points_normals(depth, K, cam_pose, target_mask, depth_threshold):
    """World-frame (obstacle points, obstacle normals, target points,
    target normals) of one depth view."""
    depth = np.asarray(depth)
    H, W = depth.shape
    normals = depth_normals(depth, K, cam_pose)

    Kinv = np.linalg.inv(np.asarray(K, dtype=np.float64))
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1).astype(np.float64)
    pts_cam = (pix @ Kinv.T) * depth[..., None].astype(np.float64)
    Rt = np.asarray(cam_pose, dtype=np.float64)
    pts_world = pts_cam @ Rt[:3, :3].T + Rt[:3, 3]

    valid = (depth > 0) & (depth < depth_threshold)
    tmask = np.asarray(target_mask, dtype=bool) if target_mask is not None else np.zeros_like(valid)
    return (
        pts_world[valid & ~tmask], normals[valid & ~tmask],
        pts_world[valid & tmask], normals[valid & tmask],
    )


def scene_point_sets_from_depth(
    depth,
    K,
    cam_pose,
    target_mask,
    capacity_obstacle: int = 2048,
    capacity_target: int = 512,
    depth_threshold: float = 1.5,
    resolution: float = 0.02,
) -> Tuple[ScenePointSet, ScenePointSet]:
    """(obstacle set without the target, target-only set) — the direct-mode
    equivalents of sdf_cost_obstacle / the target part of sdf_cost_all.

    Accepts one observation or same-length sequences of depth / cam_pose /
    target_mask (multi-view: per-view clouds are pooled before the voxel
    downsample, matching FusedDepthPointCloud's union cloud)."""
    if not isinstance(depth, (list, tuple)):
        depth, cam_pose, target_mask = [depth], [cam_pose], [target_mask]
    po, no, pt, nt = [], [], [], []
    for d, p, m in zip(depth, cam_pose, target_mask):
        a, b, c, e = _view_points_normals(d, K, p, m, depth_threshold)
        po.append(a); no.append(b); pt.append(c); nt.append(e)

    obstacle = downsample_scene(
        np.concatenate(po), np.concatenate(no), capacity_obstacle, resolution
    )
    target = downsample_scene(
        np.concatenate(pt), np.concatenate(nt), capacity_target, resolution
    )
    return obstacle, target
