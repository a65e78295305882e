"""Axis-aligned voxel grid for SDF cost fields, and the 2-D occupancy
grid of mobile-base placement.

Port of grasptrajopt_tpu/fields/voxel_grid.py (`VoxelGrid`,
`OccupancyGrid2D`). Grid construction is host numpy and identical to the
JAX package: the workspace box (`from_workspace`) or the bounds of a
scene cloud (`from_points`, `OccupancyGrid2D.from_points_bounds`), each
padded by `margin`; `pack`, the offsets and the lookups act on torch
tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from grasptrajopt_tpu_torch.ops.constants import device_vector
from grasptrajopt_tpu_torch.ops.interp import (
    field_lookup_nearest,
    field_lookup_trilinear,
    field_lookup_trilinear_packed,
    pack_corners,
    points_to_offsets,
    points_to_offsets_2d,
)

DEFAULT_MARGIN = 0.4
DEFAULT_RESOLUTION = 0.05


@dataclass(frozen=True)
class VoxelGrid:
    origin: Tuple[float, float, float]
    shape: Tuple[int, int, int]
    resolution: float

    @classmethod
    def from_workspace(
        cls,
        arm_len: float,
        arm_height: float,
        margin: float = DEFAULT_MARGIN,
        resolution: float = DEFAULT_RESOLUTION,
    ) -> "VoxelGrid":
        """xlim=[0, arm_len], ylim=[-arm_len, arm_len],
        zlim=[0, arm_height + arm_len], each padded by `margin`."""
        limits = ((0.0, arm_len), (-arm_len, arm_len), (0.0, arm_height + arm_len))
        return cls._from_limits(limits, margin, resolution)

    @classmethod
    def from_points(
        cls,
        points: np.ndarray,
        margin: float = DEFAULT_MARGIN,
        resolution: float = DEFAULT_RESOLUTION,
    ) -> "VoxelGrid":
        """The bounds of a scene cloud (N, 3), padded by `margin`."""
        points = np.asarray(points)
        lo, hi = points.min(axis=0), points.max(axis=0)
        return cls._from_limits(tuple(zip(lo, hi)), margin, resolution)

    @classmethod
    def _from_limits(cls, limits, margin, resolution) -> "VoxelGrid":
        """Axis sizes with np.arange(lo - margin, hi + margin, res)
        semantics, so shapes match the JAX package exactly."""
        axes = [np.arange(lo - margin, hi + margin, resolution) for lo, hi in limits]
        origin = (float(axes[0][0]), float(axes[1][0]), float(axes[2][0]))
        shape = (len(axes[0]), len(axes[1]), len(axes[2]))
        return cls(origin=origin, shape=shape, resolution=float(resolution))

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1] * self.shape[2]

    def grid_points(self, dtype=np.float32) -> np.ndarray:
        """All grid corner coordinates, row-major: (size, 3), host numpy."""
        ii, jj, kk = np.meshgrid(
            np.arange(self.shape[0]),
            np.arange(self.shape[1]),
            np.arange(self.shape[2]),
            indexing="ij",
        )
        idx = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3)
        return (np.asarray(self.origin) + idx * self.resolution).astype(dtype)

    def origin_tensor(self, dtype, device) -> torch.Tensor:
        return device_vector(self.origin, dtype, device)

    def offsets(self, points):
        """Flat row-major cell offsets (...,) long of (..., 3) points
        (floor + clamp)."""
        return points_to_offsets(
            points, self.origin_tensor(points.dtype, points.device), self.shape, self.resolution
        )

    def lookup_nearest(self, field_flat, points):
        return field_lookup_nearest(
            field_flat, points, self.origin_tensor(points.dtype, points.device),
            self.shape, self.resolution,
        )

    def lookup_trilinear(self, field_flat, points):
        return field_lookup_trilinear(
            field_flat, points, self.origin_tensor(points.dtype, points.device),
            self.shape, self.resolution,
        )

    def lookup(self, field_flat, points, interp: str = "trilinear"):
        """Field values at (..., 3) points: trilinear or floor-indexed."""
        if interp == "trilinear":
            return self.lookup_trilinear(field_flat, points)
        if interp == "nearest":
            return self.lookup_nearest(field_flat, points)
        raise ValueError(f"unknown interp mode '{interp}'")

    def pack(self, field_flat, dtype=None):
        """(..., size) fields -> (..., size, 8) trilinear corner rows, cast
        to `dtype` (e.g. torch.bfloat16: half the bytes a lookup reads)
        after the corners are packed, as the JAX package casts."""
        packed = pack_corners(field_flat, self.shape)
        return packed if dtype is None else packed.to(dtype)

    def lookup_packed(self, packed, points, row_offset=0):
        """Trilinear values at (..., 3) points from a `pack` table."""
        return field_lookup_trilinear_packed(
            packed, points, self.origin_tensor(points.dtype, points.device),
            self.shape, self.resolution, row_offset=row_offset,
        )


@dataclass(frozen=True)
class OccupancyGrid2D:
    """2-D x-y occupancy grid for mobile-base placement: a cell is
    occupied within `epsilon` of a scene point above the floor
    (GTORobotModel.setup_occupancy_grid)."""

    origin: Tuple[float, float]
    shape: Tuple[int, int]
    resolution: float

    @classmethod
    def from_points_bounds(
        cls,
        xys: np.ndarray,
        margin: float = DEFAULT_MARGIN,
        resolution: float = DEFAULT_RESOLUTION,
    ) -> "OccupancyGrid2D":
        """x over [0, max x], y over the points' span, each padded by
        `margin`, with np.arange's float-step lengths."""
        xlim = (0.0, float(np.max(xys[:, 0])))
        ylim = (float(np.min(xys[:, 1])), float(np.max(xys[:, 1])))
        xgrid = np.arange(xlim[0] - margin, xlim[1] + margin, resolution)
        ygrid = np.arange(ylim[0] - margin, ylim[1] + margin, resolution)
        return cls(
            origin=(float(xgrid[0]), float(ygrid[0])),
            shape=(len(xgrid), len(ygrid)),
            resolution=float(resolution),
        )

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def grid_points(self, dtype=np.float32) -> np.ndarray:
        """All cell corners, row-major: (size, 2), host numpy."""
        ii, jj = np.meshgrid(np.arange(self.shape[0]), np.arange(self.shape[1]), indexing="ij")
        idx = np.stack([ii, jj], axis=-1).reshape(-1, 2)
        return (np.asarray(self.origin) + idx * self.resolution).astype(dtype)

    def offsets(self, points_xy):
        """Flat offsets (...,) int32 of (..., 2) points (floor + clamp)."""
        origin = device_vector(self.origin, points_xy.dtype, points_xy.device)
        return points_to_offsets_2d(points_xy, origin, self.shape, self.resolution)

    def lookup(self, grid_flat, points_xy):
        """Cell values of a flat (size,) grid at (..., 2) points."""
        return grid_flat[self.offsets(points_xy).long()]
