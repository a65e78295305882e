"""Axis-aligned voxel grid for SDF cost fields.

Port of grasptrajopt_tpu/fields/voxel_grid.py (`VoxelGrid` only). Grid
construction is host numpy and identical to the JAX package; `pack` and
`lookup_nearest` act on torch tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from grasptrajopt_tpu_torch.ops.interp import field_lookup_nearest, pack_corners

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
        return torch.tensor(self.origin, dtype=dtype, device=device)

    def lookup_nearest(self, field_flat, points):
        return field_lookup_nearest(
            field_flat, points, self.origin_tensor(points.dtype, points.device),
            self.shape, self.resolution,
        )

    def pack(self, field_flat):
        """(..., size) fields -> (..., size, 8) trilinear corner rows."""
        return pack_corners(field_flat, self.shape)
