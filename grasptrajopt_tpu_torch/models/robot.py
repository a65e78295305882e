"""RobotModel: batched FK with the optimized / parameter joint split.

Port of grasptrajopt_tpu/models/robot.py (the parts the perception-to-plan
path uses): joint bookkeeping, `extract_*`, `assemble_q`, the limit arrays,
`fk_all`, `fk_components`, `frame_matrix` and `get_global_link_transform`.
The model holds its constants on one explicit device in one dtype; every
method expects tensors of that dtype on that device.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from grasptrajopt_tpu_torch.models.kinematics import KinematicModel
from grasptrajopt_tpu_torch.models.urdf import Urdf

_BIG = 1e9


def urdf_joint_limits(urdf: Urdf, joint_names: Sequence[str]):
    """(lower, upper, velocity) float64 arrays over `joint_names`, with the
    JAX package's +-1e9 defaults where the URDF gives no limit."""
    out = []
    for field, default in (("lower", -_BIG), ("upper", _BIG), ("velocity", _BIG)):
        vals = []
        for jname in joint_names:
            j = urdf.joint_map[jname]
            v = getattr(j.limit, field, None) if j.limit is not None else None
            vals.append(default if v is None else v)
        out.append(np.asarray(vals, dtype=np.float64))
    return tuple(out)


class RobotModel:
    """Kinematic tree + joint limits on one device in one dtype.

    lower / upper / velocity are float64 arrays over the ACTUATED joints;
    `param_joints` are problem inputs rather than decision variables.
    """

    def __init__(
        self,
        kinematics: KinematicModel,
        param_joints: Sequence[str],
        lower: np.ndarray,
        upper: np.ndarray,
        velocity: np.ndarray,
        device="cpu",
        dtype=torch.float32,
    ):
        self.kinematics = kinematics
        self.name = kinematics.name
        self.device = torch.device(device)
        self.dtype = dtype
        self.actuated_joint_names = list(kinematics.actuated_joint_names)
        self.param_joints = list(param_joints)
        self.parameter_joint_names = [
            j for j in self.actuated_joint_names if j in self.param_joints
        ]
        self.optimized_joint_names = [
            j for j in self.actuated_joint_names if j not in self.parameter_joint_names
        ]
        self.optimized_joint_indexes = [
            self.actuated_joint_names.index(j) for j in self.optimized_joint_names
        ]
        self.parameter_joint_indexes = [
            self.actuated_joint_names.index(j) for j in self.parameter_joint_names
        ]
        self._lower = np.asarray(lower, dtype=np.float64)
        self._upper = np.asarray(upper, dtype=np.float64)
        self._velocity = np.asarray(velocity, dtype=np.float64)
        # assemble_q as one gather: position of each full-q entry inside
        # cat([q_opt, q_param]) — no scatter, so it stays torch.func-clean
        order = self.optimized_joint_indexes + self.parameter_joint_indexes
        self._assemble_perm = torch.as_tensor(
            np.argsort(np.asarray(order, dtype=np.int64)), device=self.device
        )
        self._opt_idx = torch.as_tensor(self.optimized_joint_indexes, device=self.device)
        self._par_idx = torch.as_tensor(self.parameter_joint_indexes, device=self.device)
        self._fk_all = kinematics.fk_fn(self.device, dtype)
        self._fk_components = kinematics.fk_components_fn(self.device, dtype)

    # -- joint bookkeeping ----------------------------------------------------

    @property
    def ndof(self) -> int:
        return len(self.actuated_joint_names)

    @property
    def num_opt_joints(self) -> int:
        return len(self.optimized_joint_names)

    def extract_optimized_dimensions(self, values):
        """Select the optimized-joint entries along the LAST axis."""
        return values[..., self._opt_idx]

    def extract_parameter_dimensions(self, values):
        """Select the parameter-joint entries along the LAST axis."""
        return values[..., self._par_idx]

    def assemble_q(self, q_opt, q_param):
        """Merge optimized (..., n_opt) and parameter (..., n_param) values
        into full (..., ndof) joint order."""
        q_param = q_param.expand(q_opt.shape[:-1] + q_param.shape[-1:])
        return torch.cat([q_opt, q_param], dim=-1)[..., self._assemble_perm]

    # -- limits (float64 host arrays, as in the JAX package) ------------------

    def _limits(self, arr, idx) -> np.ndarray:
        return arr[np.asarray(idx, dtype=np.int64)]

    @property
    def lower_actuated_joint_limits(self) -> np.ndarray:
        return self._lower.copy()

    @property
    def upper_actuated_joint_limits(self) -> np.ndarray:
        return self._upper.copy()

    @property
    def velocity_actuated_joint_limits(self) -> np.ndarray:
        return self._velocity.copy()

    @property
    def lower_optimized_joint_limits(self) -> np.ndarray:
        return self._limits(self._lower, self.optimized_joint_indexes)

    @property
    def upper_optimized_joint_limits(self) -> np.ndarray:
        return self._limits(self._upper, self.optimized_joint_indexes)

    @property
    def velocity_optimized_joint_limits(self) -> np.ndarray:
        return self._limits(self._velocity, self.optimized_joint_indexes)

    # -- forward kinematics ---------------------------------------------------

    def fk_all(self, q):
        """World transform of every frame: q (..., ndof) -> (..., F, 4, 4)."""
        return self._fk_all(q)

    def fk_components(self, q):
        """Component-form FK: (R as a 3x3 nested list of (..., F), t as a
        3-list of (..., F))."""
        return self._fk_components(q)

    @staticmethod
    def frame_matrix(comps, frame_idx: int):
        """The (..., 4, 4) matrix of ONE frame from component-form FK."""
        AR, At = comps
        rows = [
            torch.stack(
                [AR[i][0][..., frame_idx], AR[i][1][..., frame_idx],
                 AR[i][2][..., frame_idx], At[i][..., frame_idx]],
                dim=-1,
            )
            for i in range(3)
        ]
        bottom = torch.zeros_like(rows[0]) + torch.tensor(
            [0.0, 0.0, 0.0, 1.0], dtype=rows[0].dtype, device=rows[0].device
        )
        return torch.stack(rows + [bottom], dim=-2)

    def frame_of(self, link: str) -> int:
        return self.kinematics.frame_of(link)

    def get_global_link_transform(self, link: str, q):
        """T_world_link for q (..., ndof) -> (..., 4, 4)."""
        return self.fk_all(q)[..., self.frame_of(link), :, :]

    @property
    def link_names(self) -> List[str]:
        return list(self.kinematics.frame_names)
