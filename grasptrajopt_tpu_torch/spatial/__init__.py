"""SE(3) and quaternion primitives (port of grasptrajopt_tpu.spatial)."""

from grasptrajopt_tpu_torch.spatial.quaternion import qangle_deg, r2quat
from grasptrajopt_tpu_torch.spatial.se3 import (
    angvec2r,
    invt,
    matmul_small,
    rt2tr,
    skew,
    standoff,
    transform_points,
)

__all__ = [
    "angvec2r", "invt", "matmul_small", "qangle_deg", "r2quat", "rt2tr",
    "skew", "standoff", "transform_points",
]
