"""Model / TaskModel / RobotModel: the user-facing robot abstraction.

Port of grasptrajopt_tpu/models/robot.py. `Model` is a named state block
with time-derivative orders and limits (states `{name}/{d*}{symbol}`, the
decision block `/x` and the parameter block `/p`); `TaskModel` a generic
task state; `RobotModel` a URDF-backed robot: joint bookkeeping (the
optimized / parameter joint split), `extract_*`, `assemble_q`, the limit
arrays, `fk_all`, `fk_components`, `frame_matrix`, the link transforms,
positions, rotations, quaternions and RPY angles, the geometric, linear,
angular and analytical Jacobians, `get_link_axis`,
`get_random_joint_positions`, inverse dynamics (`rnea`) and base-frame
re-rooting (`add_base_frame`). The model holds its constants on one
explicit device in one dtype; every method expects tensors of that dtype
on that device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.func import jacfwd

from grasptrajopt_tpu_torch.models.dynamics import make_inverse_dynamics
from grasptrajopt_tpu_torch.models.kinematics import JOINT_REVOLUTE, KinematicModel
from grasptrajopt_tpu_torch.models.urdf import (
    Urdf,
    UrdfJoint,
    UrdfLink,
    parse_urdf_file,
    parse_urdf_string,
)
from grasptrajopt_tpu_torch.models.xacro import process_xacro_file
from grasptrajopt_tpu_torch.spatial import invt, r2quat, r2rpy

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


class Model:
    """Named state block with time-derivative orders and limits: `dlim`
    maps a derivative order to its (lower, upper) arrays."""

    def __init__(self, name, dim, time_derivs, symbol, dlim, T=None, is_discrete=False):
        self.name = name
        self.dim = dim
        self.time_derivs = list(time_derivs)
        self.symbol = symbol
        self.dlim = dlim
        self.T = T
        self.is_discrete = is_discrete

    def get_name(self):
        return self.name

    def state_name(self, time_deriv: int) -> str:
        return self.name + "/" + "d" * time_deriv + self.symbol

    def state_optimized_name(self, time_deriv: int) -> str:
        return self.state_name(time_deriv) + "/x"

    def state_parameter_name(self, time_deriv: int) -> str:
        return self.state_name(time_deriv) + "/p"

    def get_limits(self, time_deriv: int):
        assert time_deriv in self.dlim, (
            f"limit for time derivative {time_deriv} not specified for model '{self.name}'"
        )
        return self.dlim[time_deriv]

    def in_limit(self, x, time_deriv: int):
        """0-dim bool tensor: every entry of x within the limits."""
        lo, up = self.get_limits(time_deriv)
        lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
        up = torch.as_tensor(up, dtype=x.dtype, device=x.device)
        return torch.logical_and(torch.all(x >= lo), torch.all(x <= up))


class TaskModel(Model):
    """Generic task state (e.g. a mobile base's (x, y, theta))."""

    def __init__(self, name, dim, time_derivs=(0,), symbol="y", dlim=None, T=None, is_discrete=False):
        super().__init__(name, dim, time_derivs, symbol, {} if dlim is None else dlim, T, is_discrete)


class RobotModel(Model):
    """URDF-backed robot on one device in one dtype, with the optimized /
    parameter joint split: `param_joints` are problem inputs rather than
    decision variables. The limit arrays are float64 host arrays."""

    def __init__(
        self,
        urdf_filename: Optional[str] = None,
        urdf_string: Optional[str] = None,
        name: Optional[str] = None,
        time_derivs: Sequence[int] = (0,),
        qddlim=None,
        T: Optional[int] = None,
        param_joints: Sequence[str] = (),
        dtype=torch.float32,
        xacro_filename: Optional[str] = None,
        device="cuda",
    ):
        if xacro_filename is not None or (urdf_filename is not None and urdf_filename.endswith(".xacro")):
            self.urdf_filename = xacro_filename or urdf_filename
            urdf = parse_urdf_string(process_xacro_file(self.urdf_filename))
        elif urdf_filename is not None:
            self.urdf_filename = urdf_filename
            urdf = parse_urdf_file(urdf_filename)
        elif urdf_string is not None:
            self.urdf_filename = None
            urdf = parse_urdf_string(urdf_string)
        else:
            raise ValueError("supply a URDF via filename or string")
        kin = KinematicModel.from_urdf(urdf)
        lower, upper, velocity = urdf_joint_limits(urdf, kin.actuated_joint_names)
        self._setup(kin, param_joints, lower, upper, velocity, device, dtype, urdf=urdf, name=name,
                    time_derivs=time_derivs, qddlim=qddlim, T=T)

    def _setup(self, kinematics, param_joints, lower, upper, velocity, device, dtype, urdf: Optional[Urdf] = None,
               name=None, time_derivs=(0,), qddlim=None, T=None) -> None:
        """The model of a flattened kinematic tree with the ACTUATED
        joints' (lower, upper, velocity) limits, and its URDF where there
        is one (GTORobotModel builds through here)."""
        self.urdf = urdf
        self.kinematics = kinematics
        self.device = torch.device(device)
        self.dtype = dtype
        self.param_joints = list(param_joints)
        self._lower = np.asarray(lower, dtype=np.float64)
        self._upper = np.asarray(upper, dtype=np.float64)
        self._velocity = np.asarray(velocity, dtype=np.float64)
        self._compile()
        dlim = {
            0: (self.lower_optimized_joint_limits, self.upper_optimized_joint_limits),
            1: (-self.velocity_optimized_joint_limits, self.velocity_optimized_joint_limits),
        }
        if qddlim is not None:
            qddlim = np.broadcast_to(np.asarray(qddlim, dtype=np.float64), (self.ndof,))
            dlim[2] = (-qddlim, qddlim)
        Model.__init__(self, name or kinematics.name, self.ndof, time_derivs, "q", dlim, T)

    def _compile(self) -> None:
        """Joint bookkeeping and the FK functions of `self.kinematics`."""
        kinematics = self.kinematics
        self.actuated_joint_names = list(kinematics.actuated_joint_names)
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
        # assemble_q as one gather: position of each full-q entry inside
        # cat([q_opt, q_param]) — no scatter, so it stays torch.func-clean
        order = self.optimized_joint_indexes + self.parameter_joint_indexes
        self._assemble_perm = torch.as_tensor(
            np.argsort(np.asarray(order, dtype=np.int64)), device=self.device
        )
        self._opt_idx = torch.as_tensor(self.optimized_joint_indexes, device=self.device)
        self._par_idx = torch.as_tensor(self.parameter_joint_indexes, device=self.device)
        self._fk_all = kinematics.fk_fn(self.device, self.dtype)
        self._fk_components = kinematics.fk_components_fn(self.device, self.dtype)

    def get_urdf(self) -> Optional[Urdf]:
        return self.urdf

    # -- joint bookkeeping ----------------------------------------------------

    @property
    def joint_names(self) -> List[str]:
        return [j.name for j in self._require_urdf("joint_names").joints]

    @property
    def ndof(self) -> int:
        return len(self.actuated_joint_names)

    def get_actuated_joint_index(self, joint_name: str) -> int:
        return self.actuated_joint_names.index(joint_name)

    @property
    def num_opt_joints(self) -> int:
        return len(self.optimized_joint_names)

    @property
    def num_param_joints(self) -> int:
        return len(self.parameter_joint_names)

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

    def get_global_link_transform_function(self, link: str, n: int = 1):
        """fn(Q): Q (ndof,) -> (4, 4), or Q (ndof, n) columns -> (n, 4, 4)."""
        f = self.frame_of(link)

        def fn(Q):
            Q = torch.as_tensor(Q, dtype=self.dtype, device=self.device)
            return self.fk_all(Q if Q.dim() == 1 else Q.T)[..., f, :, :]

        return fn

    def get_link_transform(self, link: str, q, base_link: str):
        """T_baselink_link = inv(T_world_base) @ T_world_link, q (..., ndof)."""
        frames = self.fk_all(q)
        return invt(frames[..., self.frame_of(base_link), :, :]) @ frames[..., self.frame_of(link), :, :]

    def get_link_transform_function(self, link: str, base_link: str, n: int = 1):
        """fn(Q) of get_link_transform, Q (ndof,) or (ndof, n) columns."""

        def fn(Q):
            Q = torch.as_tensor(Q, dtype=self.dtype, device=self.device)
            return self.get_link_transform(link, Q if Q.dim() == 1 else Q.T, base_link)

        return fn

    def get_global_link_position(self, link: str, q):
        return self.get_global_link_transform(link, q)[..., :3, 3]

    def get_global_link_rotation(self, link: str, q):
        return self.get_global_link_transform(link, q)[..., :3, :3]

    def get_global_link_quaternion(self, link: str, q):
        """xyzw quaternion of the link's world rotation."""
        return r2quat(self.get_global_link_rotation(link, q))

    def get_global_link_rpy(self, link: str, q):
        return r2rpy(self.get_global_link_rotation(link, q))

    # -- Jacobians --------------------------------------------------------------

    def get_global_link_geometric_jacobian(self, link: str, q):
        """Geometric Jacobian (..., 6, ndof), rows [v; w] in the world frame:
        for each actuated joint on the link's chain, v = z x (p_link -
        p_joint), w = z (revolute), or v = z, w = 0 (prismatic); zero
        columns for the other joints."""
        frames = self.fk_all(q)
        kin = self.kinematics
        f_link = self.frame_of(link)
        p_link = frames[..., f_link, :3, 3]
        zero = torch.zeros(q.shape[:-1] + (6,), dtype=q.dtype, device=q.device)
        cols = [zero] * self.ndof
        f = f_link
        while f != 0:
            jidx = int(kin.joint_index[f])
            if jidx >= 0:
                axis = torch.as_tensor(kin.axis[f], dtype=q.dtype, device=q.device)
                z = frames[..., f, :3, :3] @ axis
                if kin.joint_type[f] == JOINT_REVOLUTE:
                    cols[jidx] = torch.cat([torch.linalg.cross(z, p_link - frames[..., f, :3, 3]), z], dim=-1)
                else:
                    cols[jidx] = torch.cat([z, torch.zeros_like(z)], dim=-1)
            f = int(kin.parent[f])
        return torch.stack(cols, dim=-1)

    def get_global_link_linear_jacobian(self, link: str, q):
        return self.get_global_link_geometric_jacobian(link, q)[..., :3, :]

    def get_global_link_angular_geometric_jacobian(self, link: str, q):
        return self.get_global_link_geometric_jacobian(link, q)[..., 3:, :]

    def get_global_link_analytical_jacobian(self, link: str, q):
        """d[p; rpy]/dq (6, ndof) at one configuration q (ndof,), by
        forward-mode autodiff."""

        def pose(qq):
            T = self.get_global_link_transform(link, qq)
            return torch.cat([T[:3, 3], r2rpy(T[:3, :3])])

        return jacfwd(pose)(q)

    def get_link_axis(self, link: str, q, axis: str):
        """World direction (..., 3) of one of the link frame's axes."""
        return self.get_global_link_rotation(link, q)[..., :, {"x": 0, "y": 1, "z": 2}[axis]]

    # -- sampling -------------------------------------------------------------

    def get_random_joint_positions(self, generator: torch.Generator, n: int = 1, lo=None, hi=None, u=None):
        """(n, ndof) configurations uniform within the limits (or lo / hi),
        clipped to +-10 rad where they are unbounded. The draw comes from
        `generator` on the model's device, or is given as `u` (n, ndof) in
        [0, 1)."""
        lo = np.clip(self.lower_actuated_joint_limits if lo is None else lo, -10.0, 10.0)
        hi = np.clip(self.upper_actuated_joint_limits if hi is None else hi, -10.0, 10.0)
        if u is None:
            u = torch.rand((n, self.ndof), generator=generator, dtype=self.dtype, device=self.device)
        lo_t = torch.as_tensor(lo, dtype=self.dtype, device=self.device)
        return lo_t + u * torch.as_tensor(hi - lo, dtype=self.dtype, device=self.device)

    @property
    def link_names(self) -> List[str]:
        """The URDF's links in document order (the frames' topological
        order for a model built without a URDF)."""
        if self.urdf is None:
            return list(self.kinematics.frame_names)
        return [link.name for link in self.urdf.links]

    # -- dynamics and re-rooting ----------------------------------------------

    def _require_urdf(self, what: str) -> Urdf:
        if self.urdf is None:
            raise ValueError(f"{what} needs the URDF: '{self.name}' was built from a kinematic tree")
        return self.urdf

    def rnea(self, q, qd, qdd, gravity=(0.0, 0.0, -9.81)):
        """Inverse dynamics tau = M qdd + C qd + g (models/dynamics.py); the
        function is built once per gravity vector."""
        if getattr(self, "_idyn_cache", (None,))[0] != tuple(gravity):
            self._idyn_cache = (tuple(gravity), make_inverse_dynamics(self, gravity))
        return self._idyn_cache[1](q, qd, qdd)

    def add_base_frame(self, base_link: str, xyz=None, rpy=None, joint_name=None) -> None:
        """Re-root the model under a new fixed base frame, then rebuild
        its FK."""
        urdf = self._require_urdf("add_base_frame")
        current_root = urdf.get_root()
        if joint_name is None:
            joint_name = f"{base_link}_and_{current_root}_joint"
        urdf.add_link(UrdfLink(name=base_link))
        urdf.add_joint(
            UrdfJoint(
                name=joint_name,
                type="fixed",
                parent=base_link,
                child=current_root,
                xyz=tuple(xyz) if xyz is not None else (0.0, 0.0, 0.0),
                rpy=tuple(rpy) if rpy is not None else (0.0, 0.0, 0.0),
            )
        )
        self.kinematics = KinematicModel.from_urdf(urdf, self.actuated_joint_names)
        self._compile()
        self._idyn_cache = (None, None)
