"""Mesh surface point clouds with SDF queries (host-side asset prep).

First-party re-implementation of the mesh_to_sdf public API
(mesh_to_sdf/__init__.py: get_surface_point_cloud,
mesh_to_sdf, mesh_to_voxels, sample_sdf_near_surface;
surface_point_cloud.py: SurfacePointCloud.get_sdf with the k=11
normal-alignment sign vote). Uses scipy's cKDTree on the host — this path
runs once per robot link at model-build time; the hot runtime SDF path is
the on-device DepthPointCloud/ops.min_sqdist pipeline.

The virtual-scan surface sampling mode ('scan',
surface_point_cloud.py:157-175 + scan.py in the reference, pyrender/OpenGL
there) is provided GL-free through the software z-buffer rasterizer — see
fields/scan.py. The 'depth' sign method (camera-visibility vote across the
scans) is supported via `use_depth_buffer=True` / `sign_method='depth'`.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
from scipy.spatial import cKDTree

from grasptrajopt_tpu_torch.models.mesh import TriangleMesh


class BadMeshException(Exception):
    pass


class SurfacePointCloud:
    def __init__(
        self,
        mesh: Optional[TriangleMesh],
        points: np.ndarray,
        normals: Optional[np.ndarray] = None,
        scans=None,
    ):
        self.mesh = mesh
        self.points = np.asarray(points, dtype=np.float64)
        self.normals = None if normals is None else np.asarray(normals, dtype=np.float64)
        self.scans = scans
        self.kd_tree = cKDTree(self.points)

    def get_random_surface_points(self, count: int, seed: int = 0) -> np.ndarray:
        idx = np.random.default_rng(seed).choice(self.points.shape[0], count)
        return self.points[idx]

    def is_outside(self, query_points) -> np.ndarray:
        """True where ANY scan sees the point in free space (parity:
        surface_point_cloud.py:136-143 is_outside)."""
        assert self.scans, "is_outside needs scans (surface_point_method='scan')"
        query_points = np.asarray(query_points, dtype=np.float64)
        result = np.zeros(query_points.shape[0], dtype=bool)
        for scan in self.scans:
            result |= scan.is_visible(query_points)
        return result

    def get_sdf(
        self,
        query_points,
        sample_count: int = 11,
        return_gradients: bool = False,
        use_depth_buffer: bool = False,
    ):
        """Distance to nearest surface sample; sign by majority vote of
        normal alignment over the k nearest samples (parity:
        surface_point_cloud.py:32-64, sign_method='normal') or, with
        `use_depth_buffer`, by the scans' camera-visibility test
        (sign_method='depth')."""
        query_points = np.asarray(query_points, dtype=np.float64)
        if use_depth_buffer:
            distances, indices = self.kd_tree.query(query_points)
            sdf = distances.astype(np.float32).reshape(-1)
            inside = ~self.is_outside(query_points)
            sdf[inside] *= -1
            if return_gradients:
                gradients = query_points - self.points[indices]
                gradients[inside] *= -1
                near = np.abs(sdf) < math.sqrt(0.0025**2 * 3) * 3
                if self.normals is not None:
                    gradients = np.where(near[:, None], self.normals[indices], gradients)
                gradients /= np.maximum(np.linalg.norm(gradients, axis=1)[:, None], 1e-12)
                return sdf, gradients
            return sdf
        assert self.normals is not None, "normals required for sign determination"
        distances, indices = self.kd_tree.query(query_points, k=sample_count)
        if sample_count == 1:
            distances = distances[:, None]
            indices = indices[:, None]
        closest = self.points[indices]  # (M, k, 3)
        direction = query_points[:, None, :] - closest
        inside_votes = np.einsum("mkd,mkd->mk", direction, self.normals[indices]) < 0
        inside = inside_votes.sum(axis=1) > sample_count * 0.5
        sdf = distances[:, 0].astype(np.float32)
        sdf[inside] *= -1

        if return_gradients:
            gradients = direction[:, 0].copy()
            gradients[inside] *= -1
            near = np.abs(sdf) < math.sqrt(0.0025**2 * 3) * 3
            gradients = np.where(near[:, None], self.normals[indices[:, 0]], gradients)
            gradients /= np.maximum(np.linalg.norm(gradients, axis=1)[:, None], 1e-12)
            return sdf, gradients
        return sdf

    def get_sdf_in_batches(self, query_points, sample_count: int = 11, batch_size: int = 1_000_000, return_gradients: bool = False, use_depth_buffer: bool = False):
        query_points = np.asarray(query_points)
        if query_points.shape[0] <= batch_size:
            return self.get_sdf(query_points, sample_count, return_gradients, use_depth_buffer)
        chunks = [
            self.get_sdf(c, sample_count, return_gradients, use_depth_buffer)
            for c in np.array_split(query_points, math.ceil(query_points.shape[0] / batch_size))
        ]
        if return_gradients:
            return (
                np.concatenate([c[0] for c in chunks]),
                np.concatenate([c[1] for c in chunks]),
            )
        return np.concatenate(chunks)

    def get_voxels(self, voxel_resolution: int, sample_count: int = 11, pad: bool = False, use_depth_buffer: bool = False):
        """SDF sampled on the [-1, 1]^3 raster (parity: get_voxels +
        utils.get_raster_points)."""
        sdf = self.get_sdf_in_batches(
            get_raster_points(voxel_resolution), sample_count, use_depth_buffer=use_depth_buffer
        )
        voxels = sdf.reshape((voxel_resolution,) * 3)
        if pad:
            voxels = np.pad(voxels, 1, mode="constant", constant_values=1.0)
        return voxels

    def sample_sdf_near_surface(
        self,
        number_of_points: int = 500000,
        sample_count: int = 11,
        seed: int = 0,
        use_depth_buffer: bool = False,
    ):
        """DeepSDF-style sampling: jittered surface points + unit-sphere
        fill (parity: surface_point_cloud.py:105-134)."""
        rng = np.random.default_rng(seed)
        surface_count = int(number_of_points * 47 / 50) // 2
        surf = self.get_random_surface_points(surface_count, seed=seed)
        queries = [
            surf + rng.normal(scale=0.0025, size=surf.shape),
            surf + rng.normal(scale=0.00025, size=surf.shape),
        ]
        sphere_count = number_of_points - 2 * surface_count
        queries.append(sample_uniform_points_in_unit_sphere(sphere_count, rng))
        query_points = np.concatenate(queries).astype(np.float32)
        return query_points, self.get_sdf_in_batches(
            query_points, sample_count, use_depth_buffer=use_depth_buffer
        )


def sample_uniform_points_in_unit_sphere(count: int, rng=None) -> np.ndarray:
    rng = rng or np.random.default_rng(0)
    pts = rng.uniform(-1.0, 1.0, size=(int(count * 2.1), 3))
    pts = pts[np.linalg.norm(pts, axis=1) < 1.0][:count]
    while pts.shape[0] < count:
        extra = rng.uniform(-1.0, 1.0, size=(count, 3))
        extra = extra[np.linalg.norm(extra, axis=1) < 1.0]
        pts = np.concatenate([pts, extra])[:count]
    return pts


def get_raster_points(voxel_resolution: int) -> np.ndarray:
    axis = np.linspace(-1.0, 1.0, voxel_resolution)
    xx, yy, zz = np.meshgrid(axis, axis, axis, indexing="ij")
    return np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)


def scale_to_unit_cube(mesh: TriangleMesh) -> TriangleMesh:
    v = mesh.vertices - mesh.vertices.mean(axis=0)
    scale = 2.0 / max(np.abs(v).max(), 1e-12)
    return TriangleMesh(vertices=v * scale, faces=mesh.faces)


def scale_to_unit_sphere(mesh: TriangleMesh) -> TriangleMesh:
    v = mesh.vertices - mesh.vertices.mean(axis=0)
    scale = 1.0 / max(np.linalg.norm(v, axis=1).max(), 1e-12)
    return TriangleMesh(vertices=v * scale, faces=mesh.faces)


def get_surface_point_cloud(
    mesh: TriangleMesh,
    surface_point_method: str = "sample",
    bounding_radius: Optional[float] = None,
    scan_count: int = 100,
    scan_resolution: int = 400,
    sample_point_count: int = 10_000_000,
    calculate_normals: bool = True,
    seed: int = 0,
) -> SurfacePointCloud:
    if surface_point_method == "scan":
        from grasptrajopt_tpu_torch.fields.scan import create_from_scans

        if bounding_radius is None:
            bounding_radius = mesh.bounding_radius * 1.1
        return create_from_scans(
            mesh,
            bounding_radius=bounding_radius,
            scan_count=scan_count,
            scan_resolution=scan_resolution,
            calculate_normals=calculate_normals,
        )
    if surface_point_method != "sample":
        raise ValueError(f"unknown surface point method '{surface_point_method}'")
    points, normals = mesh.sample_surface(
        sample_point_count, seed=seed, with_normals=calculate_normals
    )
    return SurfacePointCloud(mesh, points, normals)


def _check_sign_method(surface_point_method: str, sign_method: str) -> str:
    if surface_point_method == "sample" and sign_method == "depth":
        # parity: mesh_to_sdf/__init__.py:31-33 — falls back with a notice
        print(
            "Incompatible methods for sampling points and determining sign, "
            "using sign_method='normal' instead."
        )
        return "normal"
    return sign_method


def mesh_to_sdf(
    mesh: TriangleMesh,
    query_points: np.ndarray,
    surface_point_method: str = "sample",
    sign_method: str = "normal",
    bounding_radius: Optional[float] = None,
    scan_count: int = 100,
    scan_resolution: int = 400,
    sample_point_count: int = 10_000_000,
    normal_sample_count: int = 11,
):
    sign_method = _check_sign_method(surface_point_method, sign_method)
    cloud = get_surface_point_cloud(
        mesh, surface_point_method, bounding_radius=bounding_radius,
        scan_count=scan_count, scan_resolution=scan_resolution,
        sample_point_count=sample_point_count,
    )
    return cloud.get_sdf_in_batches(
        query_points, sample_count=normal_sample_count,
        use_depth_buffer=sign_method == "depth",
    )


def mesh_to_voxels(
    mesh: TriangleMesh,
    voxel_resolution: int = 64,
    surface_point_method: str = "sample",
    sign_method: str = "normal",
    scan_count: int = 100,
    scan_resolution: int = 400,
    sample_point_count: int = 10_000_000,
    normal_sample_count: int = 11,
    pad: bool = False,
):
    sign_method = _check_sign_method(surface_point_method, sign_method)
    cloud = get_surface_point_cloud(
        scale_to_unit_cube(mesh), surface_point_method, bounding_radius=3**0.5,
        scan_count=scan_count, scan_resolution=scan_resolution,
        sample_point_count=sample_point_count,
    )
    return cloud.get_voxels(
        voxel_resolution, sample_count=normal_sample_count, pad=pad,
        use_depth_buffer=sign_method == "depth",
    )


def sample_sdf_near_surface(
    mesh: TriangleMesh,
    number_of_points: int = 500000,
    surface_point_method: str = "sample",
    sign_method: str = "normal",
    scan_count: int = 100,
    scan_resolution: int = 400,
    sample_point_count: int = 10_000_000,
    normal_sample_count: int = 11,
):
    sign_method = _check_sign_method(surface_point_method, sign_method)
    cloud = get_surface_point_cloud(
        scale_to_unit_sphere(mesh), surface_point_method, bounding_radius=1.0,
        scan_count=scan_count, scan_resolution=scan_resolution,
        sample_point_count=sample_point_count,
    )
    return cloud.sample_sdf_near_surface(
        number_of_points,
        sample_count=normal_sample_count,
        use_depth_buffer=sign_method == "depth",
    )
