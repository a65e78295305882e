"""The synthetic 7-DoF arm `synth7` in plain PyTorch: its URDF text (a
frozen copy of the program's), a serial-chain forward kinematics, and the
surface points sampled on each link's primitive (100 a link, seeded by the
CRC32 of the link's name, the program's sampling convention), plus its
workspace grid.

Nothing here is the program's: the URDF is parsed with `xml.etree`, the
chain composed with 4x4 matrix products.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
import zlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from gtobench.reference.mesh import box_mesh, cylinder_mesh

URDF = """
<robot name="synth7">
  <link name="base_link">
    <visual><geometry><cylinder radius="0.06" length="0.1"/></geometry></visual>
  </link>
  <link name="l1"><visual><geometry><box size="0.08 0.08 0.2"/></geometry></visual></link>
  <link name="l2"><visual><geometry><box size="0.07 0.07 0.25"/></geometry></visual></link>
  <link name="l3"><visual><geometry><box size="0.06 0.06 0.2"/></geometry></visual></link>
  <link name="l4"><visual><geometry><box size="0.06 0.06 0.2"/></geometry></visual></link>
  <link name="l5"><visual><geometry><box size="0.05 0.05 0.15"/></geometry></visual></link>
  <link name="l6"><visual><geometry><box size="0.05 0.05 0.1"/></geometry></visual></link>
  <link name="hand"><visual><geometry><box size="0.08 0.1 0.05"/></geometry></visual></link>
  <link name="finger_l"><visual><geometry><box size="0.015 0.02 0.06"/></geometry></visual></link>
  <link name="finger_r"><visual><geometry><box size="0.015 0.02 0.06"/></geometry></visual></link>
  <joint name="j1" type="revolute">
    <parent link="base_link"/><child link="l1"/>
    <origin xyz="0 0 0.1" rpy="0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-2.9" upper="2.9" velocity="2.1"/>
  </joint>
  <joint name="j2" type="revolute">
    <parent link="l1"/><child link="l2"/>
    <origin xyz="0 0 0.2" rpy="0 0 0"/><axis xyz="0 1 0"/>
    <limit lower="-1.8" upper="1.8" velocity="2.1"/>
  </joint>
  <joint name="j3" type="revolute">
    <parent link="l2"/><child link="l3"/>
    <origin xyz="0 0 0.25" rpy="0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-2.9" upper="2.9" velocity="2.1"/>
  </joint>
  <joint name="j4" type="revolute">
    <parent link="l3"/><child link="l4"/>
    <origin xyz="0 0 0.2" rpy="0 0 0"/><axis xyz="0 1 0"/>
    <limit lower="-3.0" upper="0.1" velocity="2.1"/>
  </joint>
  <joint name="j5" type="revolute">
    <parent link="l4"/><child link="l5"/>
    <origin xyz="0 0 0.2" rpy="0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-2.9" upper="2.9" velocity="2.6"/>
  </joint>
  <joint name="j6" type="revolute">
    <parent link="l5"/><child link="l6"/>
    <origin xyz="0 0 0.15" rpy="0 0 0"/><axis xyz="0 1 0"/>
    <limit lower="-0.1" upper="3.7" velocity="2.6"/>
  </joint>
  <joint name="j7" type="revolute">
    <parent link="l6"/><child link="hand"/>
    <origin xyz="0 0 0.1" rpy="0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-2.9" upper="2.9" velocity="2.6"/>
  </joint>
  <joint name="finger_joint_l" type="prismatic">
    <parent link="hand"/><child link="finger_l"/>
    <origin xyz="0 0.03 0.05" rpy="0 0 0"/><axis xyz="0 1 0"/>
    <limit lower="0" upper="0.04" velocity="0.2"/>
  </joint>
  <joint name="finger_joint_r" type="prismatic">
    <parent link="hand"/><child link="finger_r"/>
    <origin xyz="0 -0.03 0.05" rpy="0 0 0"/><axis xyz="0 -1 0"/>
    <limit lower="0" upper="0.04" velocity="0.2"/>
  </joint>
</robot>
"""

ARM_JOINTS = ["j1", "j2", "j3", "j4", "j5", "j6", "j7"]  # the optimized joints, in joint order
HAND = "hand"  # end-effector and gripper link


def _floats(text: str) -> np.ndarray:
    return np.array([float(v) for v in text.split()], dtype=np.float64)


def _origin(el) -> np.ndarray:
    """4x4 float64 transform of a URDF <origin> (rpy as z-y-x rotations)."""
    T = np.eye(4)
    o = el.find("origin") if el is not None else None
    if o is None:
        return T
    r, p, y = _floats(o.get("rpy", "0 0 0"))
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    T[:3, :3] = Rz @ Ry @ Rx
    T[:3, 3] = _floats(o.get("xyz", "0 0 0"))
    return T


@dataclass
class Joint:
    name: str
    kind: str
    parent: str
    child: str
    origin: np.ndarray  # (4, 4)
    axis: np.ndarray  # (3,)
    lower: float
    upper: float


class Synth7:
    """The arm on one device in one dtype: `link_transforms(q)` for full
    joint vectors q (..., 9) in the order j1..j7, finger_joint_l,
    finger_joint_r (the fingers held at the start pose's values);
    `link_points(stride)` each link's sampled points in URDF order;
    `hand_points` the hand's own sampled points."""

    def __init__(self, device, dtype=torch.float64, points_per_link: int = 100):
        root = ET.fromstring(URDF)
        self.device, self.dtype = device, dtype
        self.joints: List[Joint] = []
        for j in root.findall("joint"):
            lim = j.find("limit")
            self.joints.append(Joint(
                j.get("name"), j.get("type"), j.find("parent").get("link"), j.find("child").get("link"),
                _origin(j), _floats(j.find("axis").get("xyz")),
                float(lim.get("lower")), float(lim.get("upper")),
            ))
        self.links: List[str] = [link.get("name") for link in root.findall("link")]
        self.points: Dict[str, np.ndarray] = {}
        for link in root.findall("link"):
            geom = link.find("visual/geometry")
            box, cyl = geom.find("box"), geom.find("cylinder")
            mesh = box_mesh(_floats(box.get("size"))) if box is not None else cylinder_mesh(
                float(cyl.get("radius")), float(cyl.get("length")))
            pts, _ = mesh.sample_surface(points_per_link, seed=zlib.crc32(link.get("name").encode()))
            V = _origin(link.find("visual"))
            self.points[link.get("name")] = pts @ V[:3, :3].T + V[:3, 3]
        self.lower = np.array([j.lower for j in self.joints if j.name in ARM_JOINTS])
        self.upper = np.array([j.upper for j in self.joints if j.name in ARM_JOINTS])
        self._t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        self.hand_points = self._t(self.points[HAND])

    def link_transforms(self, q) -> Dict[str, torch.Tensor]:
        """World transform (..., 4, 4) of every link at joint vectors q
        (..., 9); the base link sits at the world origin."""
        eye = torch.eye(4, dtype=q.dtype, device=q.device)
        out = {self.links[0]: eye.expand(q.shape[:-1] + (4, 4))}
        for i, j in enumerate(self.joints):
            a = (j.axis / np.linalg.norm(j.axis)).tolist()
            qi = q[..., i]
            if j.kind == "revolute":
                c, s = torch.cos(qi)[..., None, None], torch.sin(qi)[..., None, None]
                K = self._t([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]]).to(q.dtype)
                R = eye[:3, :3] + s * K + (1 - c) * (K @ K)
                t = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
            else:  # prismatic
                R = eye[:3, :3].expand(q.shape[:-1] + (3, 3))
                t = qi[..., None] * self._t(j.axis).to(q.dtype)
            local = torch.cat([torch.cat([R, t[..., None]], -1), eye[3:].expand(q.shape[:-1] + (1, 4))], -2)
            out[j.child] = out[j.parent] @ (self._t(j.origin).to(q.dtype) @ local)
        return out

    def link_points(self, stride: int = 1) -> List[torch.Tensor]:
        """Each link's points (URDF order), every stride-th of each link."""
        return [self._t(self.points[name][::stride]) for name in self.links]


@dataclass(frozen=True)
class Grid:
    """The arm's workspace voxel grid: x over [0, arm_len], y over
    [-arm_len, arm_len], z over [0, arm_height + arm_len], each padded by
    `margin`, with np.arange's lengths; corner (i, j, k) at origin + (i, j,
    k) * resolution, flat row-major."""

    origin: Tuple[float, float, float]
    shape: Tuple[int, int, int]
    resolution: float

    @classmethod
    def workspace(cls, arm_len: float, arm_height: float, margin: float, resolution: float) -> "Grid":
        limits = ((0.0, arm_len), (-arm_len, arm_len), (0.0, arm_height + arm_len))
        axes = [np.arange(lo - margin, hi + margin, resolution) for lo, hi in limits]
        return cls(tuple(float(a[0]) for a in axes), tuple(len(a) for a in axes), float(resolution))

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def corners(self) -> np.ndarray:
        """All corners (size, 3), float32 as the configuration states the
        grid's coordinates."""
        idx = np.stack(np.meshgrid(*[np.arange(s) for s in self.shape], indexing="ij"), -1).reshape(-1, 3)
        return (np.asarray(self.origin) + idx * self.resolution).astype(np.float32)


def trilinear(field, grid: Grid, pts, offset=0):
    """Trilinear interpolation of a flat field at points (..., 3), clamped
    to the boundary cell outside the grid; `offset` (an int, or a long
    tensor broadcastable to pts[..., 0]) is added to every corner's flat
    index, to pick one of several fields stacked in `field`."""
    o = torch.as_tensor(grid.origin, dtype=pts.dtype, device=pts.device)
    u = (pts - o) / grid.resolution
    _, sy, sz = grid.shape
    base = torch.stack([torch.clamp(torch.floor(u[..., i]), 0, s - 2) for i, s in enumerate(grid.shape)], -1)
    f = torch.clamp(u - base, 0.0, 1.0)
    b = base.long()
    flat = field.reshape(-1)
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                idx = (b[..., 2] + dz) + sz * ((b[..., 1] + dy) + sy * (b[..., 0] + dx)) + offset
                w = (f[..., 0] if dx else 1 - f[..., 0]) * (f[..., 1] if dy else 1 - f[..., 1]) \
                    * (f[..., 2] if dz else 1 - f[..., 2])
                out = out + w * flat[idx].to(pts.dtype)
    return out
