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
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom = bottom + torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom], dim=-2)


def invt(T):
    """Inverse of a homogeneous transform: [R t]^-1 = [R^T, -R^T t]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
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


def standoff(offset: float, axis: str, dtype=torch.float32, device=None):
    """Pure-translation standoff transform along a named axis."""
    pose = torch.eye(4, dtype=dtype, device=device)
    pose[{"x": 0, "y": 1, "z": 2}[axis], 3] = offset
    return pose
