"""GTORobotModel: the robot as link-surface point clouds + a voxel grid.

Port of grasptrajopt_tpu/planning/gto_models.py (the field-mode parts):
surface points sampled per collision link on the host (numpy, seeded by
crc32 of the link name, so both packages get the same points bit for
bit), visual origins folded into link-frame points, `fk_surface_points`,
`surface_points_soa` with a point stride, `compute_fk_surface_points`
(host numpy points, the grasp pre-filter's gripper model),
`compute_fk_link_surface_points`, `get_standoff_pose`,
`setup_workspace_field` / `setup_points_field`, the grid's
`points_to_offsets(_numpy)` and `compute_plan_cost`; and for mobile-base
placement the 2-D occupancy grid (`setup_occupancy_grid`, built by one
K3 launch on the card) with `occupancy_cost`, and `tf_base` on the FK
point helpers.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from grasptrajopt_tpu_torch.fields.voxel_grid import OccupancyGrid2D, VoxelGrid
from grasptrajopt_tpu_torch.models.kinematics import KinematicModel, _host_rt2tr
from grasptrajopt_tpu_torch.models.mesh import geometry_mesh
from grasptrajopt_tpu_torch.models.robot import RobotModel, urdf_joint_limits
from grasptrajopt_tpu_torch.models.urdf import Urdf, parse_urdf_string
from grasptrajopt_tpu_torch.ops import nn
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
        time_derivs: Sequence[int] = (0,),
        urdf: Optional[Urdf] = None,
    ):
        self._setup(kinematics, param_joints, lower, upper, velocity, device, dtype, urdf=urdf,
                    time_derivs=time_derivs)
        self.field_margin = 0.4
        self.grid_resolution = float(grid_resolution)
        self.grid: Optional[VoxelGrid] = None
        self.occupancy: Optional[OccupancyGrid2D] = None
        # flat (size,) 0/1 cells in the robot's dtype, on its device
        self.occupancy_grid: Optional[torch.Tensor] = None
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
        time_derivs: Sequence[int] = (0,),
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
                   grid_resolution=grid_resolution, device=device, dtype=dtype,
                   time_derivs=time_derivs, urdf=urdf)

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

    def fk_surface_points(self, q, base_position=None, tf_base=None):
        """All body surface points in the world frame from matrix FK:
        q (..., ndof) -> (..., P, 3). Each link's frame is composed behind
        `tf_base` (4, 4) when given; a base translation (..., 3) is added
        last."""
        frames = self.fk_all(q)
        if tf_base is not None:
            tf_base = torch.as_tensor(tf_base, dtype=self.dtype, device=self.device)
        outs = []
        for fidx, pts in zip(self._surface_frame_idx, self._link_points_local):
            T = frames[..., fidx, :, :]
            outs.append(transform_points(T if tf_base is None else tf_base @ T, pts))
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

    def compute_fk_surface_points(self, q, tf_base=None):
        """All surface points in the world frame (or in front of `tf_base`
        (4, 4)) at one configuration q (ndof,): host numpy (P, 3). (The
        JAX method also returns the normals, which no caller reads.)"""
        return self.fk_surface_points(
            torch.as_tensor(q, dtype=self.dtype, device=self.device), tf_base=tf_base
        ).cpu().numpy()

    def visual_tf(self, link: str, q):
        """World transform (..., 4, 4) of a link's visual frame."""
        V = torch.as_tensor(self.visual_offsets[link], dtype=self.dtype, device=self.device)
        return self.get_global_link_transform(link, q) @ V

    def compute_fk_link_surface_points(self, q, name: str, tf_base=None):
        """One link's surface points in the world frame (or in front of
        `tf_base` (4, 4)) at configuration q (ndof,): host numpy (P, 3)."""
        T = self.visual_tf(name, torch.as_tensor(q, dtype=self.dtype, device=self.device))
        if tf_base is not None:
            T = torch.as_tensor(tf_base, dtype=self.dtype, device=self.device) @ T
        pts = torch.as_tensor(self.surface_points[name], dtype=self.dtype, device=self.device)
        return transform_points(T, pts).cpu().numpy()

    @staticmethod
    def get_standoff_pose(offset: float, axis: str) -> np.ndarray:
        """float32 (4, 4): a translation by `offset` along the grasp
        frame's `axis` ('x', 'y' or 'z')."""
        index = {"x": 0, "y": 1, "z": 2}.get(axis)
        if index is None:
            raise ValueError(f"unknown standoff axis {axis!r}")
        pose = np.eye(4, dtype=np.float32)
        pose[index, 3] = offset
        return pose

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

    def setup_points_field(self, points) -> VoxelGrid:
        """The grid over a scene cloud's bounds (N, 3), padded by the field
        margin."""
        self.grid = VoxelGrid.from_points(
            np.asarray(points), margin=self.field_margin, resolution=self.grid_resolution
        )
        return self.grid

    def points_to_offsets(self, points):
        """Flat cell offsets of (..., 3) points on the robot's grid."""
        return self.grid.offsets(points)

    def points_to_offsets_numpy(self, points) -> np.ndarray:
        return self.points_to_offsets(
            torch.as_tensor(np.asarray(points), dtype=self.dtype, device=self.device)
        ).cpu().numpy()

    def compute_plan_cost(self, plan, sdf_cost, base_position):
        """(cost, dist) floats of a plan (ndof, T): the summed floor-indexed
        field values at its body points, and its start-to-end distance."""
        plan = torch.as_tensor(plan, dtype=self.dtype, device=self.device)
        pts = self.fk_surface_points(plan.T, torch.as_tensor(base_position, dtype=self.dtype, device=self.device))
        vals = self.grid.lookup_nearest(torch.as_tensor(sdf_cost, dtype=self.dtype, device=self.device), pts)
        return float(torch.sum(vals)), float(torch.linalg.vector_norm(plan[:, 0] - plan[:, -1]))

    # -- occupancy (mobile base) ----------------------------------------------

    def setup_occupancy_grid(self, points, epsilon: float = 0.02) -> OccupancyGrid2D:
        """2-D occupancy grid from a scene cloud (N, 3) in the base frame:
        the grid spans the points above the floor (z > 0.01), and a cell is
        occupied where its corner at z = 0 lies within `epsilon` of one of
        them (in the plane). The distances are one K3 launch on the card
        (exact subtract-squares); the grid corners are float32-rounded, as
        in the JAX package."""
        points = np.asarray(points)
        xys = points[points[:, 2] > 0.01][:, :2]
        self.occupancy = OccupancyGrid2D.from_points_bounds(
            xys, margin=self.field_margin, resolution=self.grid_resolution
        )
        gp = self.occupancy.grid_points()
        q3 = np.concatenate([gp, np.zeros((gp.shape[0], 1), gp.dtype)], axis=1)
        r3 = np.concatenate([xys, np.zeros((xys.shape[0], 1))], axis=1)
        d2, _ = nn.min_sqdist(
            torch.as_tensor(q3, dtype=self.dtype, device=self.device),
            torch.as_tensor(r3, dtype=self.dtype, device=self.device),
        )
        self.occupancy_grid = (torch.sqrt(d2) < epsilon).to(self.dtype)
        return self.occupancy

    @property
    def occupancy_grid_shape(self):
        return self.occupancy.shape

    @property
    def occupancy_grid_size(self) -> int:
        return self.occupancy.size

    @property
    def occupancy_grid_origin(self) -> np.ndarray:
        return np.asarray(self.occupancy.origin).reshape(1, 2)

    def points_to_offsets_occupancy(self, points):
        """Flat occupancy-grid offsets (...,) int32 of (..., >= 2) points."""
        return self.occupancy.offsets(
            torch.as_tensor(points, dtype=self.dtype, device=self.device)[..., :2]
        )

    def points_to_offsets_occupancy_numpy(self, points) -> np.ndarray:
        return self.points_to_offsets_occupancy(np.asarray(points)).cpu().numpy()

    def occupancy_cost(self, q, tf_base_inv, occupancy_grid):
        """Occupied cells under the body points at configuration q
        (..., ndof) with the robot placed by `tf_base_inv` (4, 4): (...,),
        a count summed in the robot's dtype (exact in float32 far past
        2^24 cells)."""
        q = torch.as_tensor(q, dtype=self.dtype, device=self.device)
        pts = self.fk_surface_points(q, tf_base=tf_base_inv)
        grid = torch.as_tensor(occupancy_grid, dtype=self.dtype, device=self.device)
        return torch.sum(self.occupancy.lookup(grid, pts[..., :2]), dim=-1)
