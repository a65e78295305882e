"""SceneReplicaEnv: the closed-loop grasping benchmark environment.

Behavioral parity with examples/pybullet_scenereplica.py:
16 YCB objects cached behind the robot (:81-98), per-object grasp sets
(:108-112), tabletop/shelf scenes from .mat metadata with procedural shelf
generation (:279-388), robot-mounted camera rendering with NDC->metric
depth (:465-495), plan execution (:547-571), grasp reward by
gripper-object relative displacement (:574-589), IK-ladder retract
(:597-623). Import-gated on pybullet; scene data comes from the external
SceneReplica dataset (see README).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import pybullet as p
import scipy.io
import torch

from grasptrajopt_tpu_torch.envs.camera import (
    depth_from_ndc,
    projection_to_intrinsics,
    rotZ,
)
from grasptrajopt_tpu_torch.envs.grasps import load_grasps
from grasptrajopt_tpu_torch.envs.pybullet_api import Fetch, Panda

YCB_OBJECT_NAMES = (
    "003_cracker_box",
    "004_sugar_box",
    "005_tomato_soup_can",
    "006_mustard_bottle",
    "007_tuna_fish_can",
    "008_pudding_box",
    "009_gelatin_box",
    "010_potted_meat_can",
    "011_banana",
    "021_bleach_cleanser",
    "024_bowl",
    "025_mug",
    "035_power_drill",
    "037_scissors",
    "040_large_marker",
    "052_extra_large_clamp",
)

# the 20 evaluation scenes of the IROS'24 experiments
SCENE_IDS = [36, 84, 68, 10, 77, 148, 48, 25, 104, 38, 27, 122, 141, 65, 39, 83, 130, 161, 33, 56]


def _mat2quat_wxyz(R):
    from grasptrajopt_tpu_torch.spatial import r2quat

    q = r2quat(torch.as_tensor(np.asarray(R), dtype=torch.float64)).numpy()  # xyzw
    return np.array([q[3], q[0], q[1], q[2]])


class SceneReplicaEnv:
    def __init__(
        self,
        urdf_filename: str,
        data_dir: str,
        assets_dir: str,
        robot_name: str = "fetch",
        scene_type: str = "tabletop",
        mobile: bool = False,
        gui: bool = True,
        window_width: int = 640,
        window_height: int = 480,
    ):
        """`data_dir` is the SceneReplica dataset root (grasp_data,
        final_scenes, objects); `assets_dir` is this framework's data tree
        with floor/table/shelf URDFs (the reference keeps both under one
        root)."""
        self.data_dir = data_dir
        self.assets_dir = assets_dir
        self.model_dir = os.path.join(data_dir, "objects")
        self.scene_type = scene_type
        self._window_width = window_width
        self._window_height = window_height
        self.hz = 50
        self._timeStep = 1.0 / self.hz
        self.object_uids: List[int] = []
        self.object_names: List[str] = []
        self.cache_object_poses = []
        self.recorded_gripper_position = None

        self.cid = p.connect(p.GUI if gui else p.DIRECT)
        if robot_name == "panda":
            base_position = np.array([0.05, 0, 0.7])
            self.arm_height = 0.0
        else:
            base_position = np.array([0.0, 0.0, 0.0])
            self.arm_height = 1.1
        if mobile:
            base_position[0] -= 2.0
        self.base_position = base_position

        ids_file = os.path.join(data_dir, "final_scenes", "scene_ids.txt")
        self.all_scene_ids = (
            sorted(np.loadtxt(ids_file).astype(int)) if os.path.exists(ids_file) else SCENE_IDS
        )
        self.ycb_object_names = YCB_OBJECT_NAMES

        self.RT_grasps: Dict[str, np.ndarray] = {}
        for name in self.ycb_object_names:
            self.RT_grasps[name] = load_grasps(data_dir, robot_name, name)

        self.reset(urdf_filename, robot_name, base_position, mobile)

    # -- world setup ----------------------------------------------------------

    def reset(self, urdf_filename, robot_name, base_position, mobile):
        p.resetSimulation()
        p.setTimeStep(self._timeStep)
        p.setPhysicsEngineParameter(enableConeFriction=0)
        p.setGravity(0, 0, -9.81)
        p.stepSimulation()

        self.near, self.far = 0.1, 10.0

        plane_file = os.path.join(self.assets_dir, "objects", "floor", "model_normalized.urdf")
        self.plane_id = p.loadURDF(plane_file, [0, 0, 0])

        if "fetch" in robot_name:
            self.robot = Fetch(urdf_filename, base_position, self.scene_type, fix_base=not mobile)
        else:
            self.robot = Panda(urdf_filename, base_position, self.scene_type, fix_base=not mobile)
        self.robot.retract()

        if self.scene_type == "tabletop":
            table_file = os.path.join(self.assets_dir, "objects", "cafe_table", "cafe_table.urdf")
            self.table_or_shelf_pos = np.array([0.8, 0, 0.0])
            self.table_id = p.loadURDF(table_file, self.table_or_shelf_pos)
            self.table_height = 0.75
            p.changeDynamics(
                self.table_id, -1, restitution=0.1, spinningFriction=1.0,
                rollingFriction=1.0, lateralFriction=1.0,
            )
        else:
            shelf_file = os.path.join(self.assets_dir, "objects", "shelf", "shelf.urdf")
            self.table_or_shelf_pos = np.array([0.9, 0, 0.95])
            self.shelf_id = p.loadURDF(shelf_file, self.table_or_shelf_pos, [0, 0, 1, 0])
            self.shelf_height = 0.8
            self.shelf_interval = 0.2
            p.changeDynamics(
                self.shelf_id, -1, restitution=0.1, spinningFriction=1.0,
                rollingFriction=1.0, lateralFriction=1.0,
            )

        self.object_uids = []
        self.object_names = []
        self.cache_object_poses = []
        self.cache_objects()

    def cache_objects(self):
        """Park all YCB objects behind the robot (parity: :250-277)."""
        num = len(self.ycb_object_names)
        pose = np.zeros((num, 3))
        pose[:, 0] = -2.0 - np.linspace(0, 4, num)
        pose[:, 1] = 2
        for i, name in enumerate(self.ycb_object_names):
            trans = pose[i]
            orn = [0, 0, 0, 1]
            self.cache_object_poses.append((trans.copy(), np.asarray(orn).copy()))
            uid = p.loadURDF(
                os.path.join(self.model_dir, name, "model_normalized.urdf"),
                trans,
                orn,
                flags=p.URDF_ENABLE_CACHED_GRAPHICS_SHAPES,
            )
            self.object_uids.append(uid)
            self.object_names.append(name)
            p.changeDynamics(
                uid, -1, restitution=0.1, mass=0.05, spinningFriction=1.0,
                rollingFriction=1.0, lateralFriction=1.0,
            )

    def generate_shelf_meta(self, rng: Optional[np.random.Generator] = None) -> dict:
        """Procedural shelf scene metadata (parity: :286-355)."""
        rng = rng or np.random.default_rng()
        num = 6
        index = rng.permutation(len(self.ycb_object_names))[:num]
        names = [self.ycb_object_names[i] for i in index]
        meta = {"object_names": names}
        for ordering in ["nearest_first", "random"]:
            order = np.arange(num) if ordering == "nearest_first" else rng.permutation(num)
            meta[ordering] = [",".join(names[i] for i in order)]
        poses = np.zeros((num, 7))
        for i, obj in enumerate(names):
            x, y, z = self.table_or_shelf_pos
            x -= 0.1
            y = y - self.shelf_interval + (i % 3) * self.shelf_interval
            z = z + (i // 3) * self.shelf_height / 2 + 0.05
            poses[i, :3] = [x, y, z]
            fixed_quats = {
                "010_potted_meat_can": [1, 0, 0, 0],
                "021_bleach_cleanser": [1, 0, 0, 0],
                "009_gelatin_box": [0.4235242, -0.6474294, 0.2853496, 0.5657190],
                "008_pudding_box": [0.3433036, 0.3820507, 0.5692985, -0.6419339],
                "035_power_drill": [0.1540765, 0.1746546, -0.6933749, -0.6818998],
            }
            if obj in fixed_quats:
                quat = fixed_quats[obj]
            elif obj in ("003_cracker_box", "004_sugar_box"):
                quat = _mat2quat_wxyz(rotZ(np.pi / 2)[:3, :3])
            elif obj == "006_mustard_bottle":
                quat = _mat2quat_wxyz(rotZ(np.pi / 4)[:3, :3])
            else:
                quat = _mat2quat_wxyz(rotZ(rng.uniform(-np.pi, np.pi))[:3, :3])
            poses[i, 3:] = quat
        meta["poses"] = poses
        return meta

    def setup_scene(self, scene_id: int) -> dict:
        """Place the scene's objects from metadata (parity: :279-388)."""
        meta_f = "meta-%06d.mat" % scene_id
        if self.scene_type == "tabletop":
            meta = scipy.io.loadmat(os.path.join(self.data_dir, "final_scenes", "metadata", meta_f))
        else:
            path = os.path.join(self.data_dir, "shelf_scenes", "metadata", meta_f)
            if os.path.exists(path):
                meta = scipy.io.loadmat(path)
            else:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                meta = self.generate_shelf_meta()
                scipy.io.savemat(path, meta)

        names = []
        for i, obj in enumerate(meta["object_names"]):
            obj = str(obj).strip()
            names.append(obj)
            position = np.array(meta["poses"][i][:3], dtype=float)
            position[2] += 0.02
            quat = meta["poses"][i][3:]
            self.set_object_pose(obj, position, [quat[1], quat[2], quat[3], quat[0]])
        for i, name in enumerate(self.ycb_object_names):
            if name not in names:
                position, orientation = self.cache_object_poses[i]
                self.set_object_pose(name, position, orientation)
        self.set_robot_pose(self.base_position, [0, 0, 0, 1])
        p.setRealTimeSimulation(1)
        time.sleep(2.0)

        self.meta_poses = {}
        for obj in names:
            pos, orn = self.get_object_pose(obj)
            self.meta_poses[obj] = [pos, orn]
        return meta

    def reset_scene(self, set_objects):
        for obj in set_objects:
            pos, orn = self.meta_poses[obj]
            self.set_object_pose(obj, pos, orn)
        for _ in range(100):
            p.stepSimulation()

    # -- object/robot pose plumbing -------------------------------------------

    def get_object_pose(self, name):
        return p.getBasePositionAndOrientation(self.object_uids[self.object_names.index(name)])

    def set_object_pose(self, name, pos, orn):
        p.resetBasePositionAndOrientation(
            self.object_uids[self.object_names.index(name)], pos, orn
        )

    def reset_objects(self, name):
        p.resetBasePositionAndOrientation(
            self.object_uids[self.object_names.index(name)], [0, 1, 0.1], [0, 0, 0, 1]
        )

    def get_robot_pose(self):
        return p.getBasePositionAndOrientation(self.robot._id)

    def set_robot_pose(self, pos, orn):
        p.resetBasePositionAndOrientation(self.robot._id, pos, orn)

    # -- observation ----------------------------------------------------------

    def get_observation(self):
        """(rgba, metric depth, mask, cam_pose, K) from the robot camera
        (parity: :465-495)."""
        cam_view_matrix, cam_pose = self.robot.get_camera_pose()
        fov, aspect = 45, self._window_width / self._window_height
        proj_matrix = p.computeProjectionMatrixFOV(fov, aspect, self.near, self.far)
        _, _, rgba, depth, mask = p.getCameraImage(
            width=self._window_width,
            height=self._window_height,
            viewMatrix=cam_view_matrix,
            projectionMatrix=proj_matrix,
            physicsClientId=self.cid,
        )
        depth = depth_from_ndc(depth, self.near, self.far)
        K = projection_to_intrinsics(proj_matrix, self._window_width, self._window_height)
        return rgba, depth, mask, cam_pose, K

    # -- execution & reward ---------------------------------------------------

    def step(self, action):
        self.robot.cmd(action)
        for _ in range(400):
            p.stepSimulation()

    def execute_plan(self, plan):
        self.robot.execute_plan(plan)

    def record_gripper_position(self):
        pos, _ = p.getLinkState(self.robot._id, self.robot.ee_index)[:2]
        self.recorded_gripper_position = pos

    def compute_reward(self, object_name) -> int:
        """1 if the object moved WITH the gripper (relative displacement
        < 0.1 m after lift) — parity: :574-589."""
        pos_prev, _ = self.meta_poses[object_name]
        dis_prev = np.linalg.norm(np.array(pos_prev) - np.array(self.recorded_gripper_position))
        pos, _ = self.get_object_pose(object_name)
        pos_gripper, _ = p.getLinkState(self.robot._id, self.robot.ee_index)[:2]
        dis = np.linalg.norm(np.array(pos) - np.array(pos_gripper))
        return 1 if abs(dis_prev - dis) < 0.1 else 0

    def retract(self, retract_distance: float = 0.3):
        """Straight-up retreat via a PyBullet IK ladder (parity: :597-623)."""
        qc = self.robot.q()
        for idx in self.robot.finger_index:
            qc[idx] = 0
        self.step(qc)
        pos, _ = p.getLinkState(self.robot._id, self.robot.ee_index)[:2]
        offset = retract_distance / 10
        for _ in range(10):
            pos = (pos[0], pos[1], pos[2] + offset)
            joints = np.array(p.calculateInverseKinematics(self.robot._id, self.robot.ee_index, pos))
            for idx in self.robot.finger_index:
                joints[idx] = 0.0
            self.step(joints.tolist())
