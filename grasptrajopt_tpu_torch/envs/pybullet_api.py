"""PyBullet robot wrappers (host-side simulation harness).

Behavioral parity with examples/pybullet_api.py:
FixedBaseRobot joint discovery + position control + plan execution
(:159-247), Panda (:263, ee_index 7, camera link 10, fingers [7, 8]),
Fetch (:309, ee_index 16, wheels [0, 1], fingers [12, 13], differential
drive with the PathFinderController, head look-at). Import-gated: this
module requires pybullet.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import pybullet as p

from grasptrajopt_tpu_torch.envs.camera import pose_from_position_quaternion, rotX, rotZ, se3_inverse
from grasptrajopt_tpu_torch.envs.controllers import (
    PathFinderController,
    angle_mod,
    diff_drive_wheel_velocities,
)


class PyBulletSession:
    """Connection + world setup (parity: pybullet_api.py:44-99)."""

    def __init__(
        self,
        dt: float,
        add_floor: bool = True,
        camera_distance: float = 2.5,
        camera_yaw: float = 45,
        camera_pitch: float = -40,
        camera_target_position=(1.0, 0, 0.5),
        gui: bool = True,
    ):
        self.client_id = p.connect(p.GUI if gui else p.DIRECT)
        try:
            import pybullet_data

            p.setAdditionalSearchPath(pybullet_data.getDataPath())
        except ImportError:
            pass
        p.resetSimulation()
        p.setGravity(0.0, 0.0, -9.81)
        p.setTimeStep(dt)
        if gui:
            p.configureDebugVisualizer(flag=p.COV_ENABLE_GUI, enable=0)
            p.resetDebugVisualizerCamera(
                cameraDistance=camera_distance,
                cameraYaw=camera_yaw,
                cameraPitch=camera_pitch,
                cameraTargetPosition=list(camera_target_position),
            )
        if add_floor:
            self.add_floor()

    def add_floor(self, base_position=(0.0, 0.0, 0.0)):
        colid = p.createCollisionShape(p.GEOM_PLANE)
        visid = p.createVisualShape(p.GEOM_PLANE, rgbaColor=[0, 1, 0, 1.0], planeNormal=[0, 0, 1])
        p.createMultiBody(
            baseMass=0.0,
            basePosition=list(base_position),
            baseCollisionShapeIndex=colid,
            baseVisualShapeIndex=visid,
        )

    def start(self):
        p.setRealTimeSimulation(1)

    def stop(self):
        p.setRealTimeSimulation(0)

    def close(self):
        p.disconnect(self.client_id)


class FixedBaseRobot:
    """Position-controlled robot in PyBullet (parity: pybullet_api.py:159)."""

    def __init__(self, urdf_filename: str, base_position=(0.0, 0.0, 0.0), fix_base: int = 1):
        self._id = p.loadURDF(
            fileName=urdf_filename, useFixedBase=fix_base, basePosition=list(base_position)
        )
        self.urdf_filename = urdf_filename
        self.num_joints = p.getNumJoints(self._id)
        self._actuated_joints: List[int] = []
        self._actuated_joint_names: List[str] = []
        for j in range(self.num_joints):
            info = p.getJointInfo(self._id, j)
            if info[2] in {p.JOINT_REVOLUTE, p.JOINT_PRISMATIC}:
                self._actuated_joints.append(j)
                self._actuated_joint_names.append(info[1].decode())
        self.ndof = len(self._actuated_joints)
        self.position_control_gain_p = [0.01] * self.ndof
        self.position_control_gain_d = [1.0] * self.ndof
        self.max_torque = [1000] * self.ndof
        self.wheels: List[int] = []
        self.finger_index: List[int] = []

    def reset(self, q: Sequence[float]) -> None:
        for j, idx in enumerate(self._actuated_joints):
            p.resetJointState(self._id, idx, q[j])

    def cmd(self, q: Sequence[float]) -> None:
        p.setJointMotorControlArray(
            self._id,
            self._actuated_joints,
            p.POSITION_CONTROL,
            targetPositions=np.asarray(q).tolist(),
            forces=self.max_torque,
            positionGains=self.position_control_gain_p,
            velocityGains=self.position_control_gain_d,
        )
        for wheel in self.wheels:
            p.setJointMotorControl2(self._id, wheel, p.VELOCITY_CONTROL, targetVelocity=0, force=0)

    def q(self) -> List[float]:
        return [s[0] for s in p.getJointStates(self._id, self._actuated_joints)]

    def default_pose(self) -> np.ndarray:
        return np.zeros(self.ndof)

    def execute_plan(self, plan: np.ndarray, num: Optional[int] = None) -> None:
        """Step a (ndof, T) plan; the final 5 waypoints settle longer
        (parity: pybullet_api.py:231-247)."""
        for t in range(plan.shape[1]):
            self.cmd(plan[:, t])
            steps = num if num is not None else (500 if t >= plan.shape[1] - 5 else 200)
            for _ in range(steps):
                p.stepSimulation()

    def open_gripper(self):
        pass

    def close_gripper(self):
        pass

    def retract(self):
        self.cmd(self.default_pose())
        for _ in range(1000):
            p.stepSimulation()
        self.open_gripper()

    def get_standoff_pose(self, offset: float, axis: str) -> np.ndarray:
        pose = np.eye(4, dtype=np.float32)
        idx = {"x": 0, "y": 1, "z": 2}.get(axis)
        if idx is None:
            print("unknown standoff axis", axis)
        else:
            pose[idx, 3] = offset
        return pose


class Panda(FixedBaseRobot):
    def __init__(self, urdf_filename, base_position=(0.0, 0.0, 0.0), scene_type="tabletop", fix_base=1):
        super().__init__(urdf_filename, base_position, fix_base)
        self.ee_index = 7
        self.camera_link_index = 10
        self.gripper_open_offsets = [0.04, 0.04]
        self.finger_index = [7, 8]
        self.scene_type = scene_type

    def default_pose(self) -> np.ndarray:
        if self.scene_type == "tabletop":
            return np.array([0.0, -1.285, 0, -2.356, 0.0, 1.571, 0.785, 0.04, 0.04])
        return np.array([0.0, -1.285, 0, -2.356 + 1.4, 0.0, 1.571 - 0.6, 0.785, 0.0, 0.0])

    def get_camera_pose(self):
        pos, orn = p.getLinkState(self._id, self.camera_link_index)[:2]
        cam = pose_from_position_quaternion(pos, [orn[3], orn[0], orn[1], orn[2]])
        RT = cam @ rotX(-np.pi / 2) @ rotZ(-np.pi)
        pose = RT @ rotX(np.pi)
        cam_view_matrix = se3_inverse(RT).T.flatten().tolist()
        return cam_view_matrix, pose

    def close_gripper(self):
        q = self.q()
        q[-2] = q[-1] = 0.0
        self.cmd(q)
        for _ in range(1000):
            p.stepSimulation()

    def open_gripper(self):
        q = self.q()
        q[-2] = q[-1] = 0.04
        self.cmd(q)
        for _ in range(100):
            p.stepSimulation()


class Fetch(FixedBaseRobot):
    WHEEL_RADIUS = 0.0613
    WHEEL_AXLE_LENGTH = 0.372

    def __init__(self, urdf_filename, base_position=(0.0, 0.0, 0.0), scene_type="tabletop", fix_base=1):
        super().__init__(urdf_filename, base_position, fix_base)
        self.ee_index = 16
        self.camera_link_index = 7
        self.wheels = [0, 1]
        self.gripper_open_joints = [0.05, 0.05]
        self.finger_index = [12, 13]
        self.scene_type = scene_type
        self.path_controller = PathFinderController(1, 1, 3)
        self.MAX_LINEAR_SPEED = 0.1
        self.MAX_ANGULAR_SPEED = 0.1

    def default_pose(self) -> np.ndarray:
        q = np.zeros(self.ndof, dtype=np.float32)
        q[2] = 0.4  # torso
        q[3] = 0.009195
        q[4] = 0.908270 if self.scene_type == "tabletop" else 0.348270
        q[[5, 6, 7, 8, 9, 10, 11]] = [1.32, 0.7, 0.0, -2.0, 0.0, -0.57, 0.0]
        q[12] = q[13] = 0.05
        return q

    def look_at(self, pan: float, tilt: float):
        """Head pan/tilt in DEGREES; callers use keyword args
        (parity: pybullet_api.py:364, called as look_at(pan=0, tilt=10)
        from the mobile example)."""
        q = self.q()
        q[3] = np.radians(pan)
        q[4] = np.radians(tilt)
        self.cmd(q)
        for _ in range(200):
            p.stepSimulation()

    def look_at_point(self, point):
        pos, _ = p.getLinkState(self._id, self.camera_link_index)[:2]
        direction = (np.asarray(point) - pos) / np.linalg.norm(np.asarray(point) - pos)
        tilt = np.arccos(np.dot(direction, [0, 0, 1])) - np.pi / 2
        pan = np.arctan2(direction[1], direction[0])
        self.look_at(np.degrees(pan), np.degrees(tilt))

    def get_base_pose(self):
        pos, orn = p.getBasePositionAndOrientation(self._id)
        yaw = p.getEulerFromQuaternion(orn)[2]
        return pos[0], pos[1], yaw

    def cmd_wheel_velocities(self, velocities):
        for i, wheel in enumerate(self.wheels):
            p.setJointMotorControl2(
                self._id, wheel, p.VELOCITY_CONTROL, targetVelocity=velocities[i], force=5
            )

    def _clipped_wheel_cmd(self, v, w):
        v = np.clip(v, -self.MAX_LINEAR_SPEED, self.MAX_LINEAR_SPEED)
        w = np.clip(w, -self.MAX_ANGULAR_SPEED, self.MAX_ANGULAR_SPEED)
        return diff_drive_wheel_velocities(v, w, self.WHEEL_RADIUS, self.WHEEL_AXLE_LENGTH)

    def move_to_xy(self, x_delta: float, y_delta: float):
        """Closed-loop base translation (parity: pybullet_api.py:397-432)."""
        x, y, theta = self.get_base_pose()
        x_goal, y_goal = x + x_delta, y + y_delta
        rho = np.hypot(x_goal - x, y_goal - y)
        while rho > 0.01:
            rho, v, w = self.path_controller.calc_control_xy(x_goal - x, y_goal - y, theta)
            self.cmd_wheel_velocities(self._clipped_wheel_cmd(v, w))
            time.sleep(0.01)
            x, y, theta = self.get_base_pose()
        self.cmd_wheel_velocities([0, 0])

    def move_to_theta(self, theta_delta: float):
        x, y, theta = self.get_base_pose()
        theta_goal = theta + theta_delta
        beta = angle_mod(float(theta_goal - theta))
        while abs(beta) > 0.02:
            v, w = self.path_controller.calc_control_theta(theta, theta_goal)
            self.cmd_wheel_velocities(self._clipped_wheel_cmd(v, w))
            time.sleep(0.01)
            x, y, theta = self.get_base_pose()
            beta = angle_mod(float(theta_goal - theta))
        self.cmd_wheel_velocities([0, 0])

    def get_camera_pose(self):
        pos, orn = p.getLinkState(self._id, self.camera_link_index)[:2]
        cam = pose_from_position_quaternion(pos, [orn[3], orn[0], orn[1], orn[2]])
        RT = cam @ rotX(-np.pi)  # z backward
        cam_view_matrix = se3_inverse(RT).T.flatten().tolist()
        return cam_view_matrix, cam

    def close_gripper(self):
        q = self.q()
        q[12] = q[13] = 0.0
        self.cmd(q)
        for _ in range(100):
            p.stepSimulation()

    def open_gripper(self):
        q = self.q()
        q[12] = q[13] = 0.05
        self.cmd(q)
        for _ in range(100):
            p.stepSimulation()


class R2D2(FixedBaseRobot):
    """Demo robot (parity: pybullet_api.py:534)."""

    def __init__(self, urdf_filename: str, base_position=(0.0, 0.0, 0.5)):
        super().__init__(urdf_filename, base_position)


class Nextage(FixedBaseRobot):
    """Demo robot (parity: pybullet_api.py:539)."""

    def __init__(self, urdf_filename: str, base_position=(0.0, 0.0, 0.85)):
        super().__init__(urdf_filename, base_position)


class KukaLWR(FixedBaseRobot):
    """Demo robot (parity: pybullet_api.py:545)."""

    def __init__(self, urdf_filename: str, base_position=(0.0, 0.0, 0.0)):
        super().__init__(urdf_filename, base_position)
