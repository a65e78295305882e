"""Kinematics compiler: URDF tree -> flat arrays -> batched FK in torch.

Port of grasptrajopt_tpu/models/kinematics.py. The tree flattening is the
same host numpy code (topological frame order, parent pointers, joint
type/axis/index, fixed transforms). The two FK functions compose world
transforms by pointer doubling over the parent pointers, as in the JAX
package, and are written for `torch.func`: no in-place writes, no
`.item()`, no Python branching on tensor values, so they run under
`vmap(jacfwd(...))`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from grasptrajopt_tpu_torch.models.urdf import Urdf
from grasptrajopt_tpu_torch.spatial.se3 import angvec2r, matmul_small, rt2tr

JOINT_FIXED = 0
JOINT_REVOLUTE = 1  # includes 'continuous'
JOINT_PRISMATIC = 2

_TYPE_CODE = {
    "fixed": JOINT_FIXED,
    "revolute": JOINT_REVOLUTE,
    "continuous": JOINT_REVOLUTE,
    "prismatic": JOINT_PRISMATIC,
}


def _host_rt2tr(rpy, xyz) -> np.ndarray:
    """Host-side float64 fixed transform from a URDF origin."""
    r, p, y = rpy

    def rx(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    T = np.eye(4)
    T[:3, :3] = rz(y) @ ry(p) @ rx(r)
    T[:3, 3] = xyz
    return T


class KinematicModel:
    """Flat kinematic description of a tree: frames are links in
    topological order with the root at index 0. All arrays are host numpy;
    the FK functions copy them to the requested device once."""

    def __init__(
        self,
        frame_names: List[str],
        parent: np.ndarray,
        joint_type: np.ndarray,
        joint_index: np.ndarray,
        axis: np.ndarray,
        T_fixed: np.ndarray,
        actuated_joint_names: List[str],
        name: str = "robot",
    ):
        self.name = name
        self.frame_names = list(frame_names)
        self.frame_index: Dict[str, int] = {n: i for i, n in enumerate(self.frame_names)}
        self.parent = np.asarray(parent, dtype=np.int32)
        self.joint_type = np.asarray(joint_type, dtype=np.int32)
        self.joint_index = np.asarray(joint_index, dtype=np.int32)
        self.axis = np.asarray(axis, dtype=np.float64)
        self.T_fixed = np.asarray(T_fixed, dtype=np.float64)
        self.actuated_joint_names = list(actuated_joint_names)
        self.ndof = len(self.actuated_joint_names)

        F = len(self.frame_names)
        depth = np.zeros(F, dtype=np.int32)
        for f in range(1, F):
            depth[f] = depth[self.parent[f]] + 1
        self.depth = depth
        self.num_doubling_sweeps = (
            max(1, int(np.ceil(np.log2(depth.max() + 1)))) if F > 1 else 0
        )

    @classmethod
    def from_urdf(cls, urdf: Urdf, actuated_joint_names: Optional[List[str]] = None):
        """The JAX package's tree flattening, unchanged."""
        root = urdf.get_root()
        if actuated_joint_names is None:
            actuated_joint_names = urdf.actuated_joint_names
        actuated_joint_names = list(actuated_joint_names)
        joint_idx_of = {n: i for i, n in enumerate(actuated_joint_names)}

        children: Dict[str, List[str]] = {}
        for j in urdf.joints:
            children.setdefault(j.parent, []).append(j.child)
        order: List[str] = []
        stack = [root]
        while stack:
            link = stack.pop()
            order.append(link)
            stack.extend(reversed(children.get(link, [])))
        frame_index = {n: i for i, n in enumerate(order)}

        F = len(order)
        parent = np.zeros(F, dtype=np.int32)
        joint_type = np.zeros(F, dtype=np.int32)
        joint_index = np.full(F, -1, dtype=np.int32)
        axis = np.zeros((F, 3), dtype=np.float64)
        axis[:, 0] = 1.0
        T_fixed = np.tile(np.eye(4), (F, 1, 1))
        for j in urdf.joints:
            f = frame_index[j.child]
            code = _TYPE_CODE.get(j.type)
            if code is None:
                raise NotImplementedError(f"{j.type} joints are not supported")
            parent[f] = frame_index[j.parent]
            joint_type[f] = code
            if j.type != "fixed":
                joint_index[f] = joint_idx_of[j.name]
            axis[f] = np.asarray(j.axis, dtype=np.float64)
            T_fixed[f] = _host_rt2tr(j.rpy, j.xyz)
        return cls(order, parent, joint_type, joint_index, axis, T_fixed,
                   actuated_joint_names, name=urdf.name)

    def frame_of(self, link_name: str) -> int:
        if link_name not in self.frame_index:
            raise KeyError(f"link '{link_name}' does not appear in '{self.name}'")
        return self.frame_index[link_name]

    def fk_fn(self, device, dtype) -> Callable:
        """`fk_all(q (..., ndof)) -> (..., F, 4, 4)` world transforms."""
        parent0 = self.parent.copy()
        parent0[0] = 0  # root self-loop: its local transform is identity
        parent_t = torch.as_tensor(parent0, dtype=torch.long, device=device)
        jindex = torch.as_tensor(np.maximum(self.joint_index, 0), dtype=torch.long, device=device)
        has_joint = torch.as_tensor(self.joint_index >= 0, device=device)
        is_rev = torch.as_tensor(self.joint_type == JOINT_REVOLUTE, device=device)
        is_pri = torch.as_tensor(self.joint_type == JOINT_PRISMATIC, device=device)
        axis = torch.as_tensor(self.axis, dtype=dtype, device=device)
        T_fixed = torch.as_tensor(self.T_fixed, dtype=dtype, device=device)
        eye3 = torch.eye(3, dtype=dtype, device=device)
        eye4 = torch.eye(4, dtype=dtype, device=device)
        root = torch.zeros(len(self.frame_names), dtype=torch.bool, device=device)
        root[0] = True
        ptrs = [parent_t]
        for _ in range(self.num_doubling_sweeps):
            ptrs.append(ptrs[-1][ptrs[-1]])

        def fk_all(q):
            qj = q[..., jindex]
            qj = torch.where(has_joint, qj, torch.zeros_like(qj))
            R_rev = angvec2r(qj, axis)  # (..., F, 3, 3)
            R = torch.where(is_rev[:, None, None], R_rev, eye3)
            t = torch.where(is_pri[:, None], qj[..., None] * axis, torch.zeros_like(axis))
            local = matmul_small(T_fixed, rt2tr(R, t))  # (..., F, 4, 4)
            acc = torch.where(root[:, None, None], eye4, local)
            for ptr in ptrs[:-1]:
                acc = matmul_small(acc[..., ptr, :, :], acc)
            return acc

        return fk_all

    def fk_components_fn(self, device, dtype) -> Callable:
        """`fk_components(q) -> (R, t)` in component form: R a 3x3 nested
        list and t a 3-list of (..., F) tensors. Same math as `fk_fn`
        without (..., 4, 4) intermediates."""
        parent0 = self.parent.copy()
        parent0[0] = 0
        ptrs = [torch.as_tensor(parent0, dtype=torch.long, device=device)]
        for _ in range(self.num_doubling_sweeps):
            ptrs.append(ptrs[-1][ptrs[-1]])
        jindex = torch.as_tensor(np.maximum(self.joint_index, 0), dtype=torch.long, device=device)
        has_joint = torch.as_tensor(self.joint_index >= 0, device=device)
        rev = torch.as_tensor(self.joint_type == JOINT_REVOLUTE, dtype=dtype, device=device)
        pri = torch.as_tensor(self.joint_type == JOINT_PRISMATIC, dtype=dtype, device=device)
        ax = torch.as_tensor(self.axis, dtype=dtype, device=device)
        axn = ax / torch.clamp(torch.linalg.vector_norm(ax, dim=-1, keepdim=True), min=1e-12)
        Tf = torch.as_tensor(self.T_fixed, dtype=dtype, device=device)
        FR = [[Tf[:, i, j] for j in range(3)] for i in range(3)]
        Ft = [Tf[:, i, 3] for i in range(3)]
        axc = [axn[:, i] for i in range(3)]  # normalized (revolute Rodrigues)
        axr = [ax[:, i] for i in range(3)]  # raw (prismatic)
        root_mask = torch.zeros(len(self.frame_names), dtype=dtype, device=device)
        root_mask[0] = 1.0
        signs = {(0, 1): -1.0, (1, 0): 1.0, (0, 2): 1.0, (2, 0): -1.0,
                 (1, 2): -1.0, (2, 1): 1.0}

        def fk_components(q):
            qj = q[..., jindex]
            qj = torch.where(has_joint, qj, torch.zeros_like(qj))
            c = torch.cos(qj)
            s = torch.sin(qj)
            one_c = 1.0 - c

            def rod(i, j):
                eye = 1.0 if i == j else 0.0
                val = eye * c + one_c * axc[i] * axc[j]
                sign = signs.get((i, j))
                if sign is not None:
                    val = val + s * (sign * axc[3 - i - j])
                return rev * val + (1.0 - rev) * eye

            tj = [pri * qj * axr[i] for i in range(3)]
            J = [[rod(i, j) for j in range(3)] for i in range(3)]
            LR = [[sum(FR[i][k] * J[k][j] for k in range(3)) for j in range(3)] for i in range(3)]
            Lt = [sum(FR[i][k] * tj[k] for k in range(3)) + Ft[i] for i in range(3)]
            for i in range(3):
                for j in range(3):
                    LR[i][j] = LR[i][j] * (1 - root_mask) + (1.0 if i == j else 0.0) * root_mask
                Lt[i] = Lt[i] * (1 - root_mask)

            AR, At = LR, Lt
            for ptr in ptrs[:-1]:
                PR = [[AR[i][j][..., ptr] for j in range(3)] for i in range(3)]
                Pt = [At[i][..., ptr] for i in range(3)]
                AR = [[sum(PR[i][k] * AR[k][j] for k in range(3)) for j in range(3)] for i in range(3)]
                At = [sum(PR[i][k] * At[k] for k in range(3)) + Pt[i] for i in range(3)]
            return AR, At

        return fk_components
