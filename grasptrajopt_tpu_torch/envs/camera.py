"""Camera math shared by the simulation harness (pure numpy, no pybullet).

Parity targets: examples/utils.py (projection_to_intrinsics
:75-87, unpack_pose :42, se3_inverse :54) and the NDC->metric depth
conversion at examples/pybullet_scenereplica.py:492.
"""

from __future__ import annotations

import numpy as np


def quat_wxyz_to_matrix(q) -> np.ndarray:
    """wxyz quaternion -> 3x3 rotation matrix (host numpy)."""
    w, x, y, z = np.asarray(q, dtype=np.float64) / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def pose_from_position_quaternion(position, quat_wxyz) -> np.ndarray:
    """Build a 4x4 pose from position + wxyz quaternion (ref: unpack_pose)."""
    T = np.eye(4)
    T[:3, :3] = quat_wxyz_to_matrix(quat_wxyz)
    T[:3, 3] = position
    return T


def se3_inverse(RT: np.ndarray) -> np.ndarray:
    out = np.eye(4)
    R = RT[:3, :3]
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ RT[:3, 3]
    return out


def rotX(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]])


def rotY(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]])


def rotZ(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])


def projection_to_intrinsics(proj_matrix, width: int, height: int) -> np.ndarray:
    """GL projection matrix (flat, column-major) -> pinhole K.

    Parity: examples/utils.py:75-87 (including its fu/fv naming quirk — the
    [0,0] entry uses height-scaled focal length).
    """
    mat = np.asarray(proj_matrix).reshape(4, 4).T
    fv = width / 2 * mat[0, 0]
    fu = height / 2 * mat[1, 1]
    K = np.eye(3)
    K[0, 0] = fu
    K[1, 1] = fv
    K[0, 2] = width / 2
    K[1, 2] = height / 2
    return K


def depth_from_ndc(depth_ndc, z_near: float, z_far: float) -> np.ndarray:
    """PyBullet NDC depth buffer -> metric depth
    (pybullet_scenereplica.py:492)."""
    depth_ndc = np.asarray(depth_ndc)
    return z_far * z_near / (z_far - (z_far - z_near) * depth_ndc)


def intrinsics_fov(fov_deg: float, width: int, height: int) -> np.ndarray:
    """Pinhole K from a vertical FOV (the harness's camera model)."""
    f = height / (2.0 * np.tan(np.radians(fov_deg) / 2.0))
    K = np.eye(3)
    K[0, 0] = f
    K[1, 1] = f
    K[0, 2] = width / 2
    K[1, 2] = height / 2
    return K
