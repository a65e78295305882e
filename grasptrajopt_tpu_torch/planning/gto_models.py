"""GTORobotModel: the robot as link-surface point clouds + a voxel grid.

Port of grasptrajopt_tpu/planning/gto_models.py (the field-mode parts):
surface points sampled per collision link on the host (numpy, seeded by
crc32 of the link name, so both packages get the same points bit for
bit), visual origins folded into link-frame points, `fk_surface_points`,
`surface_points_soa` with a point stride, and `setup_workspace_field`.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from grasptrajopt_tpu_torch.fields.voxel_grid import VoxelGrid
from grasptrajopt_tpu_torch.models.kinematics import KinematicModel, _host_rt2tr
from grasptrajopt_tpu_torch.models.mesh import geometry_mesh
from grasptrajopt_tpu_torch.models.robot import RobotModel, urdf_joint_limits
from grasptrajopt_tpu_torch.models.urdf import parse_urdf_string
from grasptrajopt_tpu_torch.spatial import transform_points


class GTORobotModel(RobotModel):
    """Robot + per-link surface points (raw mesh-frame points, normals and
    visual offsets, as host float64 arrays keyed by link name in sampling
    order) on one device in one dtype."""

    def __init__(
        self,
        kinematics: KinematicModel,
        param_joints: Sequence[str],
        lower: np.ndarray,
        upper: np.ndarray,
        velocity: np.ndarray,
        surface_points: Dict[str, np.ndarray],
        surface_normals: Dict[str, np.ndarray],
        visual_offsets: Dict[str, np.ndarray],
        grid_resolution: float = 0.05,
        device="cuda",
        dtype=torch.float32,
    ):
        super().__init__(kinematics, param_joints, lower, upper, velocity, device, dtype)
        self.field_margin = 0.4
        self.grid_resolution = float(grid_resolution)
        self.grid: Optional[VoxelGrid] = None
        self.surface_points = {k: np.asarray(v, np.float64) for k, v in surface_points.items()}
        self.surface_normals = {k: np.asarray(v, np.float64) for k, v in surface_normals.items()}
        self.visual_offsets = {k: np.asarray(v, np.float64) for k, v in visual_offsets.items()}
        self._surface_links: List[str] = list(self.surface_points.keys())
        self._surface_frame_idx = [self.frame_of(n) for n in self._surface_links]

        local = []
        for name in self._surface_links:
            V = self.visual_offsets[name]
            local.append(self.surface_points[name] @ V[:3, :3].T + V[:3, 3])
        self._link_points_local = [
            torch.as_tensor(p, dtype=dtype, device=self.device) for p in local
        ]
        self.num_surface_points = int(sum(p.shape[0] for p in local))
        # SoA form of all points with the frame each one rides on, for the
        # component-FK path: one gather per rotation/translation component
        # instead of a per-link loop
        pts = np.concatenate(local, axis=0)
        frames = np.concatenate(
            [np.full(p.shape[0], f) for p, f in zip(local, self._surface_frame_idx)]
        )
        offsets = np.cumsum([0] + [p.shape[0] for p in local])
        self._soa_host = (pts, frames, offsets)
        self._soa_cache: Dict[int, tuple] = {}

    @classmethod
    def from_urdf_string(
        cls,
        urdf_string: str,
        param_joints: Sequence[str] = (),
        collision_link_names: Optional[List[str]] = None,
        points_per_link: int = 100,
        grid_resolution: float = 0.05,
        model_dir: str = "",
        device="cuda",
        dtype=torch.float32,
    ) -> "GTORobotModel":
        """Parse the URDF and sample each collision link's visual mesh
        exactly as the JAX package does."""
        urdf = parse_urdf_string(urdf_string)
        kin = KinematicModel.from_urdf(urdf)
        lower, upper, velocity = urdf_joint_limits(urdf, kin.actuated_joint_names)
        pts, nrm, vis = {}, {}, {}
        for link in urdf.links:
            visual = link.visual
            if visual is None:
                continue
            if collision_link_names is not None and link.name not in collision_link_names:
                continue
            mesh = geometry_mesh(visual.geometry, model_dir)
            if mesh is None:
                continue
            seed = zlib.crc32(link.name.encode())
            pts[link.name], nrm[link.name] = mesh.sample_surface(points_per_link, seed=seed)
            vis[link.name] = _host_rt2tr(visual.rpy, visual.xyz)
        return cls(kin, param_joints, lower, upper, velocity, pts, nrm, vis,
                   grid_resolution=grid_resolution, device=device, dtype=dtype)

    # -- surface point model --------------------------------------------------

    def _soa(self, stride: int):
        if stride not in self._soa_cache:
            pts, frames, offsets = self._soa_host
            keep = np.concatenate(
                [np.arange(a, b, stride) for a, b in zip(offsets[:-1], offsets[1:])]
            )
            dev, dt = self.device, self.dtype
            self._soa_cache[stride] = (
                torch.as_tensor(frames[keep], dtype=torch.long, device=dev),
                [torch.as_tensor(pts[keep, i], dtype=dt, device=dev) for i in range(3)],
            )
        return self._soa_cache[stride]

    def fk_surface_points(self, q, base_position=None):
        """All body surface points in the world frame from matrix FK:
        q (..., ndof) -> (..., P, 3), optionally shifted by a base
        translation (..., 3)."""
        frames = self.fk_all(q)
        outs = [
            transform_points(frames[..., fidx, :, :], pts)
            for fidx, pts in zip(self._surface_frame_idx, self._link_points_local)
        ]
        world = torch.cat(outs, dim=-2)
        if base_position is not None:
            world = world + base_position[..., None, :]
        return world

    def surface_points_soa(self, comps, base_position=None, stride: int = 1):
        """World surface points (x, y, z), each (..., P), from component FK.

        Per point: r0 * px + r1 * py + r2 * pz + t with the rotation and
        translation components of the frame the point rides on — the same
        arithmetic, in the same order, as the JAX package's per-link loop.
        stride > 1 keeps every stride-th point of each link (the coarse
        obstacle phase). base_position (..., 3) is added last.
        """
        AR, At = comps
        fidx, (px, py, pz) = self._soa(stride)
        out = []
        for i in range(3):
            w = (
                AR[i][0][..., fidx] * px
                + AR[i][1][..., fidx] * py
                + AR[i][2][..., fidx] * pz
                + At[i][..., fidx]
            )
            if base_position is not None:
                w = w + base_position[..., i, None]
            out.append(w)
        return tuple(out)

    def gripper_points(self, link: str) -> torch.Tensor:
        """The raw surface points of one link (the planner's goal-matching
        point set)."""
        return torch.as_tensor(self.surface_points[link], dtype=self.dtype, device=self.device)

    # -- voxel field ----------------------------------------------------------

    def setup_workspace_field(self, arm_len: float, arm_height: float) -> VoxelGrid:
        self.grid = VoxelGrid.from_workspace(
            arm_len, arm_height, margin=self.field_margin, resolution=self.grid_resolution
        )
        return self.grid
