"""Virtual-scan surface sampling: depth scans from cameras on a sphere.

First-party re-implementation of mesh_to_sdf/scan.py
(:49-120 Scan, :139-147 get_equidistant_camera_angles, :149-169
create_from_scans) without any GL dependency — the renders run through the
software z-buffer rasterizer (envs/render.py). Behavior
kept: `scan_count` cameras at Fibonacci-sphere angles, distance
2 x bounding_radius, 60-degree FOV, every hit pixel backprojects to one
surface point with a camera-facing normal; each Scan retains its depth
buffer so `is_visible` can answer the depth sign test
(sign_method='depth', surface_point_cloud.py:44-49 in the reference).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from grasptrajopt_tpu_torch.envs.camera import intrinsics_fov
from grasptrajopt_tpu_torch.envs.render import look_at_pose, render_depth
from grasptrajopt_tpu_torch.models.mesh import TriangleMesh


def get_equidistant_camera_angles(count: int):
    """Fibonacci-spiral angles (phi, theta) — parity: scan.py:139-147."""
    increment = math.pi * (3 - math.sqrt(5))
    for i in range(count):
        theta = math.asin(-1 + 2 * i / (count - 1))
        phi = ((i + 1) * increment) % (2 * math.pi)
        yield phi, theta


def camera_position(phi: float, theta: float, distance: float) -> np.ndarray:
    """Position of the reference's rotY(phi) @ rotX(theta) @ [0,0,d] camera
    (scan.py:15-20): on the sphere of radius `distance` around the origin."""
    # rotX(theta) @ [0,0,d] = [0, -d sin(theta), d cos(theta)]
    y = -distance * math.sin(theta)
    z = distance * math.cos(theta)
    # rotY(phi) @ [0, y, z]
    return np.array([math.sin(phi) * z, y, math.cos(phi) * z])


class Scan:
    """One virtual depth scan of a mesh (parity: scan.py:49-120)."""

    def __init__(
        self,
        mesh: TriangleMesh,
        cam_pose: np.ndarray,
        resolution: int = 400,
        fov: float = 1.0472,
        calculate_normals: bool = True,
    ):
        self.cam_pose = np.asarray(cam_pose, dtype=np.float64)
        self.camera_position = self.cam_pose[:3, 3]
        self.resolution = resolution
        self.K = intrinsics_fov(math.degrees(fov), resolution, resolution)

        depth, _, face_idx = render_depth(
            [(mesh, np.eye(4), 0)], self.cam_pose, self.K,
            resolution, resolution, background_depth=0.0, with_faces=True,
        )
        self.depth_buffer = depth

        vs, us = np.nonzero(depth > 0)
        z = depth[vs, us].astype(np.float64)
        K_inv = np.linalg.inv(self.K)
        pix = np.stack([us + 0.5, vs + 0.5, np.ones_like(z)], axis=1)
        pts_cam = (pix @ K_inv.T) * z[:, None]
        R = self.cam_pose[:3, :3]
        t = self.cam_pose[:3, 3]
        self.points = pts_cam @ R.T + t

        if calculate_normals:
            normals = mesh.face_normals[face_idx[vs, us]].copy()
            to_cam = self.camera_position - self.points
            flip = np.einsum("ij,ij->i", to_cam, normals) < 0
            normals[flip] *= -1
            self.normals = normals
        else:
            self.normals = None

    def is_visible(self, points: np.ndarray) -> np.ndarray:
        """True where a world point is strictly in front of this scan's
        surface (parity: scan.py:108-119, metric-depth formulation)."""
        q = np.asarray(points, dtype=np.float64)
        R = self.cam_pose[:3, :3]
        t = self.cam_pose[:3, 3]
        pc = (q - t) @ R
        z = pc[:, 2]
        safe_z = np.where(np.abs(z) > 1e-12, z, 1e-12)
        u = (self.K[0, 0] * pc[:, 0] / safe_z + self.K[0, 2]).astype(int)
        v = (self.K[1, 1] * pc[:, 1] / safe_z + self.K[1, 2]).astype(int)
        in_viewport = (
            (u >= 0) & (v >= 0) & (u < self.resolution) & (v < self.resolution) & (z > 0)
        )
        out = np.zeros(q.shape[0], dtype=bool)
        uc = np.clip(u, 0, self.resolution - 1)
        vc = np.clip(v, 0, self.resolution - 1)
        measured = self.depth_buffer[vc, uc].astype(np.float64)
        # empty pixels are infinitely far (parity: scan.py:63 depth==0 -> inf)
        measured = np.where(measured > 0, measured, np.inf)
        out[in_viewport] = (z < measured)[in_viewport]
        return out


def create_from_scans(
    mesh: TriangleMesh,
    bounding_radius: float = 1.0,
    scan_count: int = 100,
    scan_resolution: int = 400,
    calculate_normals: bool = True,
):
    """Scan the mesh from `scan_count` sphere cameras and fuse the point
    clouds (parity: scan.py:149-169; returns a SurfacePointCloud with the
    scans attached for the 'depth' sign method)."""
    from grasptrajopt_tpu_torch.fields.surface_point_cloud import SurfacePointCloud

    scans: List[Scan] = []
    for phi, theta in get_equidistant_camera_angles(scan_count):
        eye = camera_position(phi, theta, 2.0 * bounding_radius)
        cam_pose = look_at_pose(eye, [0.0, 0.0, 0.0])
        scans.append(
            Scan(
                mesh,
                cam_pose,
                resolution=scan_resolution,
                fov=1.0472,
                calculate_normals=calculate_normals,
            )
        )
    return SurfacePointCloud(
        mesh,
        points=np.concatenate([s.points for s in scans], axis=0),
        normals=(
            np.concatenate([s.normals for s in scans], axis=0)
            if calculate_normals
            else None
        ),
        scans=scans,
    )
