"""Minimal first-party URDF parser (host-side, pure Python stdlib).

Covers the slice of URDF the framework needs — links (visual/collision
origin + mesh/primitive geometry), joints (type, origin, axis, limits),
tree topology — replacing the reference's urdf_parser_py dependency
(optas/models.py:12-15, 288).

The parsed `Urdf` is a plain host object; `models.kinematics` compiles it
into flat arrays for on-device FK.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

JOINT_TYPES = ("fixed", "revolute", "continuous", "prismatic", "floating", "planar")


def _parse_floats(text: Optional[str], default: Tuple[float, ...]) -> Tuple[float, ...]:
    if text is None:
        return default
    vals = tuple(float(v) for v in text.replace(",", " ").split())
    return vals if vals else default


@dataclass
class UrdfGeometry:
    """One geometry element: exactly one of mesh / box / cylinder / sphere."""

    mesh_filename: Optional[str] = None
    mesh_scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    box_size: Optional[Tuple[float, float, float]] = None
    cylinder_radius: Optional[float] = None
    cylinder_length: Optional[float] = None
    sphere_radius: Optional[float] = None


@dataclass
class UrdfVisual:
    xyz: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rpy: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    geometry: UrdfGeometry = field(default_factory=UrdfGeometry)


@dataclass
class UrdfInertial:
    mass: float = 0.0
    xyz: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rpy: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # inertia tensor entries about the inertial frame
    ixx: float = 0.0
    ixy: float = 0.0
    ixz: float = 0.0
    iyy: float = 0.0
    iyz: float = 0.0
    izz: float = 0.0

    def inertia_matrix(self):
        import numpy as _np

        return _np.array(
            [
                [self.ixx, self.ixy, self.ixz],
                [self.ixy, self.iyy, self.iyz],
                [self.ixz, self.iyz, self.izz],
            ]
        )


@dataclass
class UrdfLink:
    name: str
    visuals: List[UrdfVisual] = field(default_factory=list)
    collisions: List[UrdfVisual] = field(default_factory=list)
    inertial: Optional[UrdfInertial] = None

    @property
    def visual(self) -> Optional[UrdfVisual]:
        """First visual element (reference semantics: urdf_link.visual)."""
        return self.visuals[0] if self.visuals else None


@dataclass
class UrdfLimit:
    lower: Optional[float] = None
    upper: Optional[float] = None
    velocity: Optional[float] = None
    effort: Optional[float] = None


@dataclass
class UrdfJoint:
    name: str
    type: str
    parent: str
    child: str
    xyz: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rpy: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    axis: Tuple[float, float, float] = (1.0, 0.0, 0.0)  # URDF default axis
    limit: Optional[UrdfLimit] = None


class Urdf:
    """Parsed URDF robot description with tree accessors.

    API parity notes: `get_root`, `get_chain(root, link, links=False)`,
    `link_map` / `joint_map`, `add_link` / `add_joint` mirror the
    urdf_parser_py surface the reference relies on
    (optas/models.py:552-588 add_base_frame; :846 get_chain).
    """

    def __init__(self, name: str, links: List[UrdfLink], joints: List[UrdfJoint]):
        self.name = name
        self.links = links
        self.joints = joints
        self._rebuild_maps()

    def _rebuild_maps(self) -> None:
        self.link_map: Dict[str, UrdfLink] = {l.name: l for l in self.links}
        self.joint_map: Dict[str, UrdfJoint] = {j.name: j for j in self.joints}
        self._child_to_joint: Dict[str, UrdfJoint] = {j.child: j for j in self.joints}

    def get_root(self) -> str:
        children = {j.child for j in self.joints}
        roots = [l.name for l in self.links if l.name not in children]
        if len(roots) != 1:
            raise ValueError(f"URDF '{self.name}' has {len(roots)} root links: {roots}")
        return roots[0]

    def get_chain(self, root: str, tip: str, links: bool = True) -> List[str]:
        """Names along the path root->tip; joints only when links=False."""
        chain: List[str] = []
        link = tip
        while link != root:
            joint = self._child_to_joint.get(link)
            if joint is None:
                raise ValueError(f"no path from '{root}' to '{tip}' in URDF '{self.name}'")
            if links:
                chain.append(link)
            chain.append(joint.name)
            link = joint.parent
        if links:
            chain.append(root)
        chain.reverse()
        return chain

    def add_link(self, link: UrdfLink) -> None:
        self.links.append(link)
        self._rebuild_maps()

    def add_joint(self, joint: UrdfJoint) -> None:
        self.joints.append(joint)
        self._rebuild_maps()

    @property
    def actuated_joint_names(self) -> List[str]:
        return [j.name for j in self.joints if j.type != "fixed"]


def _parse_origin(elem: Optional[ET.Element]) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    if elem is None:
        return (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)
    xyz = _parse_floats(elem.get("xyz"), (0.0, 0.0, 0.0))
    rpy = _parse_floats(elem.get("rpy"), (0.0, 0.0, 0.0))
    return xyz, rpy


def _parse_geometry(elem: Optional[ET.Element]) -> UrdfGeometry:
    geom = UrdfGeometry()
    if elem is None:
        return geom
    mesh = elem.find("mesh")
    if mesh is not None:
        geom.mesh_filename = mesh.get("filename")
        geom.mesh_scale = _parse_floats(mesh.get("scale"), (1.0, 1.0, 1.0))[:3]
    box = elem.find("box")
    if box is not None:
        geom.box_size = _parse_floats(box.get("size"), (0.0, 0.0, 0.0))[:3]
    cyl = elem.find("cylinder")
    if cyl is not None:
        geom.cylinder_radius = float(cyl.get("radius", 0.0))
        geom.cylinder_length = float(cyl.get("length", 0.0))
    sph = elem.find("sphere")
    if sph is not None:
        geom.sphere_radius = float(sph.get("radius", 0.0))
    return geom


def _parse_visual_like(elem: ET.Element) -> UrdfVisual:
    xyz, rpy = _parse_origin(elem.find("origin"))
    return UrdfVisual(xyz=xyz, rpy=rpy, geometry=_parse_geometry(elem.find("geometry")))


def parse_urdf_string(text: str) -> Urdf:
    root = ET.fromstring(text)
    if root.tag != "robot":
        raise ValueError(f"expected <robot> root element, got <{root.tag}>")
    name = root.get("name", "robot")

    links: List[UrdfLink] = []
    for link_elem in root.findall("link"):
        link = UrdfLink(name=link_elem.get("name", ""))
        for v in link_elem.findall("visual"):
            link.visuals.append(_parse_visual_like(v))
        for c in link_elem.findall("collision"):
            link.collisions.append(_parse_visual_like(c))
        inertial_elem = link_elem.find("inertial")
        if inertial_elem is not None:
            xyz, rpy = _parse_origin(inertial_elem.find("origin"))
            mass_elem = inertial_elem.find("mass")
            inertia_elem = inertial_elem.find("inertia")

            def _ia(attr):
                if inertia_elem is None:
                    return 0.0
                return float(inertia_elem.get(attr, 0.0))

            link.inertial = UrdfInertial(
                mass=float(mass_elem.get("value", 0.0)) if mass_elem is not None else 0.0,
                xyz=xyz,
                rpy=rpy,
                ixx=_ia("ixx"), ixy=_ia("ixy"), ixz=_ia("ixz"),
                iyy=_ia("iyy"), iyz=_ia("iyz"), izz=_ia("izz"),
            )
        links.append(link)

    joints: List[UrdfJoint] = []
    for joint_elem in root.findall("joint"):
        jtype = joint_elem.get("type", "fixed")
        if jtype not in JOINT_TYPES:
            raise ValueError(f"unsupported joint type '{jtype}'")
        parent = joint_elem.find("parent")
        child = joint_elem.find("child")
        if parent is None or child is None:
            raise ValueError(f"joint '{joint_elem.get('name')}' missing parent/child")
        xyz, rpy = _parse_origin(joint_elem.find("origin"))
        axis_elem = joint_elem.find("axis")
        axis = (
            _parse_floats(axis_elem.get("xyz"), (1.0, 0.0, 0.0))[:3]
            if axis_elem is not None
            else (1.0, 0.0, 0.0)
        )
        limit_elem = joint_elem.find("limit")
        limit = None
        if limit_elem is not None:
            limit = UrdfLimit(
                lower=(float(limit_elem.get("lower")) if limit_elem.get("lower") else None),
                upper=(float(limit_elem.get("upper")) if limit_elem.get("upper") else None),
                velocity=(
                    float(limit_elem.get("velocity")) if limit_elem.get("velocity") else None
                ),
                effort=(float(limit_elem.get("effort")) if limit_elem.get("effort") else None),
            )
        joints.append(
            UrdfJoint(
                name=joint_elem.get("name", ""),
                type=jtype,
                parent=parent.get("link", ""),
                child=child.get("link", ""),
                xyz=xyz,
                rpy=rpy,
                axis=axis,
                limit=limit,
            )
        )

    return Urdf(name=name, links=links, joints=joints)


def parse_urdf_file(path: str) -> Urdf:
    with open(path, "r") as f:
        return parse_urdf_string(f.read())
