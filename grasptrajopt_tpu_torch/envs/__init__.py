"""Simulation and benchmark environments: synthetic scenes, the software
depth camera and camera helpers (host numpy), and the PyBullet
SceneReplica harness.

Port of grasptrajopt_tpu/envs. PyBullet is an optional dependency: the
pure-math pieces (camera models, grasp loading, the differential-drive
controller) import unconditionally; the simulator classes import only
when a module named `pybullet` is importable (the real engine, or
`envs.fake_pybullet` after its `install()`).
"""

from grasptrajopt_tpu_torch.envs.camera import (
    depth_from_ndc,
    pose_from_position_quaternion,
    projection_to_intrinsics,
    se3_inverse,
)
from grasptrajopt_tpu_torch.envs.grasps import load_grasps, parse_grasps
from grasptrajopt_tpu_torch.envs.controllers import PathFinderController, angle_mod, diff_drive_wheel_velocities

try:
    import pybullet  # noqa: F401

    HAS_PYBULLET = True
except ImportError:
    HAS_PYBULLET = False

if HAS_PYBULLET:
    from grasptrajopt_tpu_torch.envs.pybullet_api import (  # noqa: F401
        Fetch,
        FixedBaseRobot,
        Panda,
        PyBulletSession,
    )
    from grasptrajopt_tpu_torch.envs.scene_replica import SceneReplicaEnv  # noqa: F401

__all__ = [
    "HAS_PYBULLET",
    "depth_from_ndc",
    "pose_from_position_quaternion",
    "projection_to_intrinsics",
    "se3_inverse",
    "load_grasps",
    "parse_grasps",
    "PathFinderController",
    "angle_mod",
    "diff_drive_wheel_velocities",
]
