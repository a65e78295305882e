"""SyntheticSceneEnv: a pybullet-free closed-loop grasping benchmark.

The reference's quality story is closed-loop PyBullet replay on SceneReplica
(examples/pybullet_scenereplica.py +
pybullet_evaluate_plans.py). Neither pybullet nor the SceneReplica
`.mat`/grasp dataset is available in every environment, so this module
provides the same *evaluation semantics* with first-party pieces:

  - procedurally generated tabletop / shelf scenes of YCB-sized primitive
    objects (same table/shelf placement as pybullet_scenereplica.py:135-153)
  - analytic antipodal grasp sets per object (the role of the dataset's
    pre-computed grasps, pybullet_scenereplica.py:108-112)
  - depth + segmentation observations from the software z-buffer renderer
    (envs/render.py), matching get_observation (:465-495)
  - kinematic execution: a plan "succeeds" when its final end-effector pose
    reaches one of the object's grasps within the reference's own IK
    acceptance gates (pos < 1 cm... relaxed to 2 cm for the final step,
    rot < 10 deg; pybullet_gto_planning.py:262) AND the replayed trajectory
    is collision-free under the reference's criterion (> 5 body points with
    sdf < 0 at any step => collision, pybullet_evaluate_plans.py:219-237).

The scoring driver (examples/synthetic_eval.py) writes the reference's
result-JSON schema so utils/results.py aggregates it exactly like the
IROS'24 files.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from grasptrajopt_tpu_torch.envs.camera import intrinsics_fov
from grasptrajopt_tpu_torch.envs.render import look_at_pose, render_depth
from grasptrajopt_tpu_torch.models.mesh import TriangleMesh, box_mesh, cylinder_mesh

# -- grasp frame conventions --------------------------------------------------
# approach axis / closing axis of the end-effector frame per robot:
# panda_hand: +z approaches, fingers translate along y (panda.yaml link_ee)
# fetch wrist_roll_link: +x approaches, fingers along y (fetch.yaml)
GRASP_CONVENTIONS = {
    "panda": {"approach": "z", "closing": "y", "backoff": 0.1034},
    "fetch": {"approach": "x", "closing": "y", "backoff": 0.35},
}

_AXIS = {"x": 0, "y": 1, "z": 2}


def _normalize(v):
    v = np.asarray(v, dtype=np.float64)
    return v / max(np.linalg.norm(v), 1e-12)


def grasp_pose(point, approach, closing, convention: Dict) -> np.ndarray:
    """End-effector pose whose `approach` axis points along `approach` with
    fingers closing along `closing`, fingertip midpoint at `point`."""
    a = _normalize(approach)
    c = np.asarray(closing, dtype=np.float64)
    c = _normalize(c - (c @ a) * a)
    R = np.zeros((3, 3))
    ia, ic = _AXIS[convention["approach"]], _AXIS[convention["closing"]]
    it = 3 - ia - ic
    R[:, ia] = a
    R[:, ic] = c
    # cyclic rule col_k = col_{k+1} x col_{k+2} keeps det(R) = +1
    R[:, it] = np.cross(R[:, (it + 1) % 3], R[:, (it + 2) % 3])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = np.asarray(point, dtype=np.float64) - convention["backoff"] * a
    return T


GRASP_DEPTH = 0.02  # fingertips overlap the surface by 2 cm
MAX_WIDTH = 0.075  # graspable span (panda max opening 0.08)


def cylinder_grasps(r: float, h: float, n_side: int = 8, n_top: int = 4,
                    convention: Optional[Dict] = None) -> List[np.ndarray]:
    """Antipodal grasps of an upright cylinder (object origin: bottom
    center). Side pinches around the barrel at two heights (shelf scenes
    often block one band — near the board below, or under the board
    above); top-down pinches across the rim when the diameter fits the
    gripper. The height spread mirrors the diversity of the reference's
    per-object grasp databases (~50-100 grasps/object)."""
    conv = convention or GRASP_CONVENTIONS["panda"]
    out = []
    if 2 * r <= MAX_WIDTH:
        for frac in (0.45, 0.7):
            for phi in np.linspace(0, 2 * np.pi, n_side, endpoint=False):
                a = np.array([-np.cos(phi), -np.sin(phi), 0.0])
                point = np.array([0.0, 0.0, frac * h]) - a * (r - GRASP_DEPTH)
                out.append(grasp_pose(point, a, [-np.sin(phi), np.cos(phi), 0.0], conv))
        for psi in np.linspace(0, 2 * np.pi, n_top, endpoint=False):
            point = np.array([0.0, 0.0, h - GRASP_DEPTH])
            out.append(grasp_pose(point, [0, 0, -1.0], [np.cos(psi), np.sin(psi), 0.0], conv))
    return out


def box_grasps(sx: float, sy: float, sz: float, convention: Optional[Dict] = None) -> List[np.ndarray]:
    """Antipodal grasps of an axis-aligned box (origin: bottom center):
    top-down across each graspable horizontal span (with slide offsets
    along the free span), side pinches through the faces perpendicular to
    a graspable span at two heights. The added diversity mirrors the
    reference's per-object grasp databases and matters most in shelves,
    where clearance blocks whole grasp families."""
    conv = convention or GRASP_CONVENTIONS["panda"]
    out = []

    def span_grasps(close_ax: np.ndarray, free_ax: np.ndarray, free_len: float):
        # top-down, sliding along the free span
        z_top = np.array([0.0, 0.0, sz - GRASP_DEPTH])
        off_max = min(0.25 * free_len, 0.05)
        offsets = (0.0,) if off_max < 0.015 else (-off_max, 0.0, off_max)
        for off in offsets:
            for flip in (1.0, -1.0):
                out.append(grasp_pose(z_top + off * free_ax, [0, 0, -1.0], flip * close_ax, conv))
        # side pinches approaching along -+free_ax, at two heights
        fracs = (0.6,) if sz < 0.06 else (0.45, 0.7)
        for frac in fracs:
            for sign in (1.0, -1.0):
                a = -sign * free_ax
                point = sign * (free_len / 2 - GRASP_DEPTH) * free_ax + np.array([0.0, 0.0, frac * sz])
                out.append(grasp_pose(point, a, close_ax, conv))

    if sx <= MAX_WIDTH:  # closing along x, free span along y
        span_grasps(np.array([1.0, 0.0, 0.0]), np.array([0.0, 1.0, 0.0]), sy)
    if sy <= MAX_WIDTH:  # closing along y, free span along x
        span_grasps(np.array([0.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0]), sx)
    return out


# -- object catalog -----------------------------------------------------------


@dataclass
class SynthObject:
    """A YCB-sized primitive: mesh in an object frame with the origin at the
    bottom center, z up, plus its grasp generator parameters."""

    name: str
    mesh: TriangleMesh
    height: float
    radius_xy: float  # footprint radius for collision-free placement

    def grasps(self, convention: Dict) -> np.ndarray:
        raise NotImplementedError


@dataclass
class _Cylinder(SynthObject):
    r: float = 0.03

    def grasps(self, convention):
        return np.stack(cylinder_grasps(self.r, self.height, convention=convention))


@dataclass
class _Box(SynthObject):
    sx: float = 0.05
    sy: float = 0.05

    def grasps(self, convention):
        return np.stack(box_grasps(self.sx, self.sy, self.height, convention=convention))


def _make_cylinder(name, r, h) -> _Cylinder:
    mesh = cylinder_mesh(r, h, segments=24)
    mesh = TriangleMesh(vertices=mesh.vertices + [0, 0, h / 2], faces=mesh.faces)
    return _Cylinder(name=name, mesh=mesh, height=h, radius_xy=r, r=r)


def _make_box(name, sx, sy, sz) -> _Box:
    mesh = box_mesh([sx, sy, sz])
    mesh = TriangleMesh(vertices=mesh.vertices + [0, 0, sz / 2], faces=mesh.faces)
    return _Box(name=name, mesh=mesh, height=sz, radius_xy=float(np.hypot(sx, sy)) / 2, sx=sx, sy=sy)


def default_catalog() -> Dict[str, SynthObject]:
    """Six YCB-dimensioned primitives (names match the benchmark set,
    pybullet_scenereplica.py:31-48; dimensions from the YCB spec sheets)."""
    return {
        o.name: o
        for o in [
            _make_cylinder("005_tomato_soup_can", r=0.033, h=0.101),
            _make_box("004_sugar_box", sx=0.038, sy=0.089, sz=0.175),
            _make_cylinder("006_mustard_bottle", r=0.029, h=0.19),
            _make_box("009_gelatin_box", sx=0.028, sy=0.085, sz=0.073),
            _make_box("010_potted_meat_can", sx=0.05, sy=0.097, sz=0.082),
            _make_cylinder("021_bleach_cleanser", r=0.033, h=0.25),
        ]
    }


# -- the environment ----------------------------------------------------------


@dataclass
class _PlacedObject:
    obj: SynthObject
    pose: np.ndarray  # world_from_object
    uid: int
    active: bool = True


class SyntheticSceneEnv:
    """Deterministic synthetic SceneReplica-style scenes with rendered
    observations and kinematic execution."""

    TABLE_POS = np.array([0.8, 0.0, 0.0])  # pybullet_scenereplica.py:137
    TABLE_HEIGHT = 0.75
    SHELF_POS = np.array([0.9, 0.0, 0.95])  # :146

    def __init__(
        self,
        robot_name: str = "panda",
        scene_type: str = "tabletop",
        n_objects: int = 5,
        width: int = 160,
        height: int = 160,
        fov_deg: float = 52.0,
        depth_threshold: float = 1.5,
    ):
        assert scene_type in ("tabletop", "shelf")
        self.robot_name = robot_name
        self.scene_type = scene_type
        self.n_objects = n_objects
        self.width = width
        self.height = height
        self.depth_threshold = depth_threshold
        self.K = intrinsics_fov(fov_deg, width, height)
        self.catalog = default_catalog()
        self.convention = GRASP_CONVENTIONS[robot_name]

        # base placement parity: pybullet_scenereplica.py:92-98
        if robot_name == "panda":
            self.base_position = np.array([0.05, 0.0, 0.7])
        else:
            self.base_position = np.array([0.0, 0.0, 0.0])

        self._static_meshes = self._build_furniture()
        self.objects: List[_PlacedObject] = []
        self.meta: Dict = {}

    # -- world construction ---------------------------------------------------

    def _build_furniture(self) -> List[Tuple[TriangleMesh, np.ndarray, int]]:
        """Table or shelf as box meshes (ids < 0 are furniture; -1 is kept
        for 'no hit', so furniture ids start at -2)."""
        out = []
        if self.scene_type == "tabletop":
            # solid slab: top surface at TABLE_HEIGHT
            slab = box_mesh([0.913, 1.3, 0.05])
            pose = np.eye(4)
            pose[:3, 3] = self.TABLE_POS + [0.0, 0.0, self.TABLE_HEIGHT - 0.025]
            out.append((slab, pose, -2))
            # pedestal (keeps plans from sweeping through the table volume)
            ped = box_mesh([0.6, 0.8, self.TABLE_HEIGHT - 0.05])
            pose2 = np.eye(4)
            pose2[:3, 3] = self.TABLE_POS + [0.0, 0.0, (self.TABLE_HEIGHT - 0.05) / 2]
            out.append((ped, pose2, -3))
        else:
            x, y, z = self.SHELF_POS
            board = box_mesh([0.35, 0.8, 0.04])
            back = box_mesh([0.04, 0.8, 0.9])
            side = box_mesh([0.35, 0.04, 0.9])
            for k, bz in enumerate((z, z + 0.4)):  # boards at 0.95 and 1.35
                p = np.eye(4)
                p[:3, 3] = [x, y, bz - 0.02]
                out.append((board, p, -2 - k))
            pb = np.eye(4)
            pb[:3, 3] = [x + 0.195, y, z + 0.4]
            out.append((back, pb, -4))
            for k, sy in enumerate((-0.42, 0.42)):
                p = np.eye(4)
                p[:3, 3] = [x, y + sy, z + 0.4]
                out.append((side, p, -5 - k))
            # support column below the bottom board
            col = box_mesh([0.35, 0.8, z - 0.04])
            pc = np.eye(4)
            pc[:3, 3] = [x, y, (z - 0.04) / 2]
            out.append((col, pc, -7))
        return out

    def _placement_region(self):
        if self.scene_type == "tabletop":
            return (0.40, 0.66), (-0.26, 0.26), self.TABLE_HEIGHT
        # single reachable shelf level, using the usable board depth (board
        # spans x 0.48-0.83; stay clear of the front edge and the back wall).
        # The original deep-only strip (0.74-0.80) could not fit 5 objects
        # with clearance and the sampler fell through to OVERLAPPING
        # placements in every scene — physically invalid benchmarks.
        return (0.60, 0.80), (-0.28, 0.28), float(self.SHELF_POS[2])

    def setup_scene(self, scene_id: int) -> Dict:
        """Choose + place `n_objects` catalog objects deterministically from
        `scene_id`; returns metadata with the two evaluation orderings
        (parity: setup_scene + ordering metadata, pybullet_scenereplica.py
        :279-388)."""
        rng = np.random.default_rng(scene_id)
        names = list(self.catalog.keys())
        sel = [names[i] for i in rng.permutation(len(names))[: self.n_objects]]
        (x0, x1), (y0, y1), z = self._placement_region()

        placed: List[_PlacedObject] = []
        for uid, name in enumerate(sel):
            obj = self.catalog[name]
            ok = False
            for _ in range(500):
                x = rng.uniform(x0, x1)
                y = rng.uniform(y0, y1)
                ok = all(
                    np.hypot(x - p.pose[0, 3], y - p.pose[1, 3])
                    > (obj.radius_xy + p.obj.radius_xy + 0.06)
                    for p in placed
                )
                if ok:
                    break
            if not ok:
                # never place interpenetrating objects — a scene with fewer
                # objects is a valid benchmark; an unphysical one is not
                continue
            yaw = rng.uniform(-np.pi, np.pi)
            c, s = np.cos(yaw), np.sin(yaw)
            pose = np.eye(4)
            pose[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            pose[:3, 3] = [x, y, z]
            placed.append(_PlacedObject(obj=obj, pose=pose, uid=uid))
        self.objects = placed

        dists = [np.linalg.norm(p.pose[:2, 3] - self.base_position[:2]) for p in placed]
        order_near = [placed[i].obj.name for i in np.argsort(dists)]
        order_rand = [placed[i].obj.name for i in rng.permutation(len(placed))]
        self.meta = {
            "scene_id": scene_id,
            "object_names": [p.obj.name for p in placed],
            "nearest_first": ",".join(order_near),
            "random": ",".join(order_rand),
        }
        return self.meta

    def reset_scene(self, set_objects=None) -> None:
        """Re-activate every placed object (parity: reset_scene)."""
        for p in self.objects:
            p.active = True

    def remove_object(self, name: str) -> None:
        """Take an object out of the scene after its grasp attempt
        (parity: reset_objects — the reference parks it off-table)."""
        for p in self.objects:
            if p.obj.name == name:
                p.active = False

    def _placed(self, name: str) -> _PlacedObject:
        for p in self.objects:
            if p.obj.name == name:
                return p
        raise KeyError(name)

    # -- observation ----------------------------------------------------------

    def camera_pose(self) -> np.ndarray:
        """A head-height camera looking at the workspace (stand-in for the
        robot-mounted camera of pybullet_api.py:280-290)."""
        if self.scene_type == "tabletop":
            eye = self.base_position + [0.08, 0.0, 0.95]
            target = [0.58, 0.0, self.TABLE_HEIGHT]
        else:
            eye = self.base_position + [0.0, 0.0, 0.9]
            target = [float(self.SHELF_POS[0]) - 0.12, 0.0, float(self.SHELF_POS[2]) + 0.12]
        return look_at_pose(eye, target)

    def camera_poses(self, n_views: int = 1) -> List[np.ndarray]:
        """Head camera plus, for n_views >= 2, a complementary vantage.

        A single head-height view leaves an occlusion band under the upper
        shelf board that the visibility sign test marks 'inside' — blocking
        every deep-shelf wrist posture in both planning and replay (the
        dominant synthetic-shelf failure, docs/PERF.md). The second view
        looks into the gap from the opposite vertical side, the way a real
        robot would peek before reaching (the reference's fetch re-aims its
        head camera with look_at, pybullet_api.py:364-383)."""
        poses = [self.camera_pose()]
        if n_views >= 2:
            if self.scene_type == "shelf":
                x, _, z = self.SHELF_POS
                gap_mid = z + 0.2
                head_z = float(self.base_position[2]) + 0.9
                if head_z > gap_mid:  # head above the gap -> peek from below
                    eye = [float(self.base_position[0]) + 0.15, 0.0, gap_mid - 0.15]
                    target = [x - 0.12, 0.0, z + 0.3]
                else:  # head below -> peek from above
                    eye = [float(self.base_position[0]) + 0.15, 0.0, gap_mid + 0.25]
                    target = [x - 0.12, 0.0, z + 0.1]
            else:
                eye = self.base_position + [0.25, 0.45, 0.75]
                target = [0.58, 0.0, self.TABLE_HEIGHT]
            poses.append(look_at_pose(np.asarray(eye, float), np.asarray(target, float)))
        return poses[:n_views]

    def get_observation(self, cam_pose: Optional[np.ndarray] = None):
        """(depth, mask, cam_pose, K): depth in meters, mask = per-pixel
        object uid (-1 background, negative ids furniture).

        `cam_pose` overrides the default head camera — the mobile driver
        renders from the robot's moving base (look_at parity:
        pybullet_api.py:364-383).

        Background pixels get the FAR depth (10 m, PyBullet's far plane,
        pybullet_scenereplica.py:124): the visibility sign test of
        DepthPointCloud.is_outside must see background rays as free space
        all the way out, exactly like the reference's depth images."""
        meshes = list(self._static_meshes)
        for p in self.objects:
            if p.active:
                meshes.append((p.obj.mesh, p.pose, p.uid))
        if cam_pose is None:
            cam_pose = self.camera_pose()
        depth, ids = render_depth(
            meshes, cam_pose, self.K, self.width, self.height, background_depth=10.0
        )
        return depth, ids, cam_pose, self.K

    # -- grasps ---------------------------------------------------------------

    def grasps_world(self, name: str, capacity: Optional[int] = None) -> np.ndarray:
        """The object's grasp set as world end-effector poses, optionally
        repeated up to a fixed capacity (static shapes across objects)."""
        p = self._placed(name)
        local = p.obj.grasps(self.convention)
        world = p.pose[None] @ local
        if capacity is not None:
            assert capacity >= world.shape[0], (capacity, world.shape)
            reps = int(np.ceil(capacity / world.shape[0]))
            world = np.tile(world, (reps, 1, 1))[:capacity]
        return world
