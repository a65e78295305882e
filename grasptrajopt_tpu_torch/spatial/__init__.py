"""SE(3) and quaternion primitives (port of grasptrajopt_tpu/spatial)."""

from grasptrajopt_tpu_torch.spatial.quaternion import (
    qangle_deg,
    qconj,
    qmul,
    quat2r,
    r2quat,
    rotation_angle_deg,
)
from grasptrajopt_tpu_torch.spatial.se3 import (
    angvec2r,
    invt,
    matmul_small,
    r2rpy,
    rotx,
    roty,
    rotz,
    rpy2r,
    rt2tr,
    skew,
    standoff,
    tr2rt,
    transform_directions,
    transform_points,
)

__all__ = [
    "angvec2r", "invt", "matmul_small", "qangle_deg", "qconj", "qmul", "quat2r", "r2quat",
    "r2rpy", "rotation_angle_deg", "rotx", "roty", "rotz", "rpy2r", "rt2tr", "skew",
    "standoff", "tr2rt", "transform_directions", "transform_points",
]
