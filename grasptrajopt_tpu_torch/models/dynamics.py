"""Inverse dynamics: tau = M(q) qdd + C(q, qd) qd + g(q).

Port of grasptrajopt_tpu/models/dynamics.py. The torques come from the
Lagrangian with automatic differentiation over the robot's batched FK:

    KE(q, qd) = 1/2 sum_l [ m_l |v_cl|^2 + w_l . (I_l^world w_l) ]
    PE(q)     = - sum_l m_l (gravity . p_cl)
    tau       = d/dt (dKE/dqd) - dKE/dq + dPE/dq

Link twists come from one `torch.func.jvp` through `fk_all`; the d/dt term
is another jvp of the qd-gradient along (qd, qdd). Revolute, continuous
and prismatic joints all flow through the same FK. `mass_matrix`,
`gravity_vector` and `coriolis_vector` probe the same function.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from torch.func import grad, jvp, vmap

from grasptrajopt_tpu_torch.models.kinematics import _host_rt2tr


def _unskew(W):
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def make_inverse_dynamics(robot, gravity: Sequence[float] = (0.0, 0.0, -9.81)) -> Callable:
    """Build `idyn(q, qd, qdd) -> tau` (each (ndof,)) for a RobotModel
    whose URDF has inertials."""
    masses = []
    com_local = []  # COM position in the link frame
    inertia_local = []  # inertia tensor in the link frame (about the COM)
    frame_idx = []
    for link in robot._require_urdf("inverse dynamics").links:
        inr = link.inertial
        if inr is None or inr.mass <= 0.0:
            continue
        T_inr = _host_rt2tr(inr.rpy, inr.xyz)
        R_inr = T_inr[:3, :3]
        masses.append(inr.mass)
        com_local.append(T_inr[:3, 3])
        inertia_local.append(R_inr @ inr.inertia_matrix() @ R_inr.T)
        frame_idx.append(robot.frame_of(link.name))

    if not masses:
        raise ValueError(f"URDF '{robot.urdf.name}' has no inertial elements")

    dtype, dev = robot.dtype, robot.device
    m = torch.as_tensor(np.asarray(masses), dtype=dtype, device=dev)  # (L,)
    c_loc = torch.as_tensor(np.asarray(com_local), dtype=dtype, device=dev)  # (L, 3)
    I_loc = torch.as_tensor(np.asarray(inertia_local), dtype=dtype, device=dev)  # (L, 3, 3)
    fidx = torch.as_tensor(frame_idx, dtype=torch.long, device=dev)
    grav = torch.as_tensor(gravity, dtype=dtype, device=dev)

    def com_positions(q):
        frames = robot.fk_all(q)[fidx]  # (L, 4, 4)
        R = frames[:, :3, :3]
        p = frames[:, :3, 3]
        return p + torch.einsum("lij,lj->li", R, c_loc), R

    def kinetic_energy(q, qd):
        (p_c, R), (v_c, dR) = jvp(com_positions, (q,), (qd,))
        w = _unskew(dR @ R.transpose(-1, -2))  # world angular velocity
        I_w = R @ I_loc @ R.transpose(-1, -2)
        lin = torch.sum(m * torch.sum(v_c * v_c, dim=-1))
        ang = torch.sum(w * torch.einsum("lij,lj->li", I_w, w))
        return 0.5 * (lin + ang)

    def potential_energy(q):
        p_c, _ = com_positions(q)
        return -torch.sum(m * (p_c @ grav))

    dKE_dqd = grad(kinetic_energy, argnums=1)
    dKE_dq = grad(kinetic_energy, argnums=0)
    dPE_dq = grad(potential_energy)

    def idyn(q, qd, qdd):
        q, qd, qdd = (torch.as_tensor(v, dtype=dtype, device=dev) for v in (q, qd, qdd))
        # d/dt of the generalized momentum along the trajectory (qd, qdd)
        _, dmom = jvp(dKE_dqd, (q, qd), (qd, qdd))
        return dmom - dKE_dq(q, qd) + dPE_dq(q)

    return idyn


def mass_matrix(robot, q, gravity=(0.0, 0.0, -9.81)):
    """M(q) (ndof, ndof) by probing inverse dynamics with unit
    accelerations at qd = 0, gravity removed."""
    idyn = make_inverse_dynamics(robot, gravity=(0.0, 0.0, 0.0))
    q = torch.as_tensor(q, dtype=robot.dtype, device=robot.device)
    zeros = torch.zeros(robot.ndof, dtype=robot.dtype, device=robot.device)
    eye = torch.eye(robot.ndof, dtype=robot.dtype, device=robot.device)
    cols = vmap(lambda e: idyn(q, zeros, e))(eye)
    return cols.T


def gravity_vector(robot, q, gravity=(0.0, 0.0, -9.81)):
    idyn = make_inverse_dynamics(robot, gravity=gravity)
    zeros = torch.zeros(robot.ndof, dtype=robot.dtype, device=robot.device)
    return idyn(q, zeros, zeros)


def coriolis_vector(robot, q, qd, gravity=(0.0, 0.0, -9.81)):
    idyn = make_inverse_dynamics(robot, gravity=(0.0, 0.0, 0.0))
    zeros = torch.zeros(robot.ndof, dtype=robot.dtype, device=robot.device)
    return idyn(q, qd, zeros)
