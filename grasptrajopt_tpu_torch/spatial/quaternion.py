"""Quaternion ops (scalar-last xyzw), port of
grasptrajopt_tpu/spatial/quaternion.py: the Hamilton product and
conjugate, the conversions to and from rotation matrices, and the IK
screen's rotation-error metric."""

from __future__ import annotations

import math

import torch


def qconj(q):
    """Conjugate of xyzw quaternions (..., 4)."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def qmul(q1, q2):
    """Hamilton product of xyzw quaternions, broadcasting over batch axes."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat2r(q):
    """xyzw quaternion (..., 4), normalized here -> rotation (..., 3, 3)."""
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    x, y, z, w = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def r2quat(R):
    """Rotation matrix (..., 3, 3) -> xyzw quaternion (..., 4).

    Branch-free Shepperd extraction: all four candidates are computed and
    the best-conditioned one is selected by index, as in the JAX package.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    one = torch.ones_like(tr)
    qw2 = torch.clamp(one + tr, min=0.0)
    qx2 = torch.clamp(one + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(one - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(one - m00 - m11 + m22, min=0.0)
    eps = 1e-12

    sw = torch.sqrt(qw2 + eps)
    cand_w = torch.stack([(m21 - m12) / (2 * sw), (m02 - m20) / (2 * sw),
                          (m10 - m01) / (2 * sw), sw / 2], dim=-1)
    sx = torch.sqrt(qx2 + eps)
    cand_x = torch.stack([sx / 2, (m01 + m10) / (2 * sx),
                          (m02 + m20) / (2 * sx), (m21 - m12) / (2 * sx)], dim=-1)
    sy = torch.sqrt(qy2 + eps)
    cand_y = torch.stack([(m01 + m10) / (2 * sy), sy / 2,
                          (m12 + m21) / (2 * sy), (m02 - m20) / (2 * sy)], dim=-1)
    sz = torch.sqrt(qz2 + eps)
    cand_z = torch.stack([(m02 + m20) / (2 * sz), (m12 + m21) / (2 * sz),
                          sz / 2, (m10 - m01) / (2 * sz)], dim=-1)

    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(norm, min=eps)


def qangle_deg(q1, q2):
    """Angle (degrees) between two xyzw quaternions: arccos(2<q1,q2>^2 - 1)."""
    d = torch.sum(q1 * q2, dim=-1)
    c = torch.clamp(2.0 * d * d - 1.0, -1.0, 1.0)
    return torch.arccos(c) * (180.0 / math.pi)


def rotation_angle_deg(R1, R2):
    """Relative rotation angle (degrees) between rotation matrices."""
    return qangle_deg(r2quat(R1), r2quat(R2))
