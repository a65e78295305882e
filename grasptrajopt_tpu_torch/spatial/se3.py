"""SE(3)/SO(3) primitives on torch tensors.

Port of grasptrajopt_tpu/spatial/se3.py. Every function broadcasts over
leading batch axes, keeps the input dtype and device, writes nothing in
place, and has no data-dependent Python branching, so all of them run
under `torch.func.vmap` / `torch.func.jacfwd`.
"""

from __future__ import annotations

import torch


def skew(v):
    """Skew-symmetric matrix [v]x with shape (..., 3, 3) from (..., 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    rows = [
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _rot(theta, rows_of):
    """(...,) angles -> (..., 3, 3) from a function of (c, s, one, zero)
    giving the three rows."""
    c, s = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([torch.stack(r, dim=-1) for r in rows_of(c, s, one, zero)], dim=-2)


def rotx(theta):
    """Rotation about x: (...,) -> (..., 3, 3)."""
    return _rot(theta, lambda c, s, one, zero: ((one, zero, zero), (zero, c, -s), (zero, s, c)))


def roty(theta):
    """Rotation about y: (...,) -> (..., 3, 3)."""
    return _rot(theta, lambda c, s, one, zero: ((c, zero, s), (zero, one, zero), (-s, zero, c)))


def rotz(theta):
    """Rotation about z: (...,) -> (..., 3, 3)."""
    return _rot(theta, lambda c, s, one, zero: ((c, -s, zero), (s, c, zero), (zero, zero, one)))


def rpy2r(rpy):
    """Roll-pitch-yaw (..., 3) -> rotation (..., 3, 3), the URDF convention
    R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    return rotz(rpy[..., 2]) @ roty(rpy[..., 1]) @ rotx(rpy[..., 0])


def r2rpy(R):
    """Rotation (..., 3, 3) -> roll-pitch-yaw (..., 3) with R = Rz@Ry@Rx, by
    atan2; at the pitch singularity (cos(pitch) < 1e-6) yaw is 0 and roll
    takes the rest of the rotation."""
    cy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    pitch = torch.atan2(-R[..., 2, 0], cy)
    singular = cy < 1e-6
    roll = torch.where(
        singular,
        torch.atan2(-R[..., 1, 2], R[..., 1, 1]),
        torch.atan2(R[..., 2, 1], R[..., 2, 2]),
    )
    yaw = torch.where(singular, torch.zeros_like(pitch), torch.atan2(R[..., 1, 0], R[..., 0, 0]))
    return torch.stack([roll, pitch, yaw], dim=-1)


def angvec2r(theta, v):
    """Rodrigues rotation: angle (...,) about an axis (..., 3), normalized
    internally with a zero-axis guard."""
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    axis = v / torch.clamp(norm, min=1e-12)
    K = skew(axis)
    c = torch.cos(theta)[..., None, None]
    s = torch.sin(theta)[..., None, None]
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(K.shape)
    return eye + s * K + (1.0 - c) * (K @ K)


def rt2tr(R, t):
    """Rotation (..., 3, 3) + translation (..., 3) -> homogeneous (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # [0, 0, 0, 1] by fills: a host constant would synchronize the stream
    bottom = torch.cat(
        [torch.zeros(batch + (1, 3), dtype=R.dtype, device=R.device),
         torch.ones(batch + (1, 1), dtype=R.dtype, device=R.device)],
        dim=-1,
    )
    return torch.cat([top, bottom], dim=-2)


def tr2rt(T):
    """Homogeneous (..., 4, 4) -> (rotation (..., 3, 3), translation (..., 3))."""
    return T[..., :3, :3], T[..., :3, 3]


def invt(T):
    """Inverse of a homogeneous transform: [R t]^-1 = [R^T, -R^T t]."""
    R, t = tr2rt(T)
    Rt = R.transpose(-1, -2)
    return rt2tr(Rt, -(Rt @ t[..., :, None])[..., 0])


def matmul_small(A, B):
    """(..., m, k) @ (..., k, n) as broadcast-multiply + reduce — the JAX
    package's elementwise form, kept for bitwise-close parity."""
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def transform_points(T, points):
    """Apply (..., 4, 4) transforms to (..., N, 3) points -> (..., N, 3)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    out = torch.sum(points[..., :, None, :] * R[..., None, :, :], dim=-1)
    return out + t[..., None, :]


def transform_directions(T, dirs):
    """Rotate (..., N, 3) direction vectors by the rotation part of T."""
    return torch.sum(dirs[..., :, None, :] * T[..., None, :3, :3], dim=-1)


def standoff(offset: float, axis: str, dtype=torch.float32, device=None):
    """Pure-translation standoff transform along a named axis."""
    pose = torch.eye(4, dtype=dtype, device=device)
    pose[{"x": 0, "y": 1, "z": 2}[axis], 3].fill_(offset)  # a fill: assigning a float copies it from the host
    return pose
