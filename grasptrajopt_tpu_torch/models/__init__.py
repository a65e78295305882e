"""Robot models: URDF parsing, meshes, kinematics (port of grasptrajopt_tpu.models)."""

from grasptrajopt_tpu_torch.models.urdf import Urdf, UrdfJoint, UrdfLink, parse_urdf_file, parse_urdf_string
from grasptrajopt_tpu_torch.models.kinematics import KinematicModel
from grasptrajopt_tpu_torch.models.robot import RobotModel, TaskModel

__all__ = [
    "Urdf",
    "UrdfJoint",
    "UrdfLink",
    "parse_urdf_file",
    "parse_urdf_string",
    "KinematicModel",
    "RobotModel",
    "TaskModel",
]
