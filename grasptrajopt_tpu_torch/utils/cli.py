"""What the port's command-line entry points share: the device they run
on, a robot's models and config, paths in an asset tree, the simulator
gate and a synchronized clock."""

from __future__ import annotations

import os
import sys
import time

import torch

from grasptrajopt_tpu_torch.planning.gto_models import GTORobotModel
from grasptrajopt_tpu_torch.planning.utils import get_data_dir, load_robot_config
from grasptrajopt_tpu_torch.testing import (
    SYNTH_EVAL_CONFIG,
    make_synthetic_gripper,
    make_synthetic_gto_robot,
)


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on: cuda (float32 on the card, TF32
    off: the solver is specified at full float32) or cpu (float64, the
    kernels' plain versions); no fallback from one to the other."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch sees no CUDA device (pass --device cpu)")
    device = torch.device(name)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def robot_config(robot_name: str, data_dir: str = None, synth_config: dict = SYNTH_EVAL_CONFIG) -> dict:
    """A robot's config: `synth_config` for synth7, else configs/<robot>.yaml
    of the data tree."""
    if robot_name == "synth7":
        return dict(synth_config)
    return load_robot_config(robot_name, data_dir or get_data_dir())


def build_models(robot_name: str, data_dir: str = None, grid_resolution: float = 0.05,
                 dtype=None, device="cuda", synth_config: dict = SYNTH_EVAL_CONFIG):
    """(robot, gripper, cfg): the synthetic arm and its gripper with
    `synth_config`, or a robot and its gripper from the data tree's URDFs
    and config. dtype None: float32 on the card (K4 takes float32 only),
    float64 on the CPU."""
    if dtype is None:
        dtype = torch.float32 if torch.device(device).type == "cuda" else torch.float64
    cfg = robot_config(robot_name, data_dir, synth_config)
    if robot_name == "synth7":
        robot = make_synthetic_gto_robot(device, dtype, grid_resolution=grid_resolution)
        return robot, make_synthetic_gripper(device, dtype), cfg
    data_dir = data_dir or get_data_dir()
    model_dir = os.path.join(data_dir, "robots", cfg["robot_name"])

    def urdf(key):
        with open(asset_path(data_dir, cfg, key)) as f:
            return f.read()

    robot = GTORobotModel.from_urdf_string(
        urdf("urdf_robot_path"), param_joints=cfg["param_joints"],
        collision_link_names=cfg["collision_link_names"], grid_resolution=grid_resolution,
        model_dir=model_dir, device=device, dtype=dtype,
    )
    robot.setup_workspace_field(arm_len=cfg["arm_len"], arm_height=cfg["arm_height"])
    gripper = GTORobotModel.from_urdf_string(
        urdf("urdf_gripper_path"), model_dir=model_dir, device=device, dtype=dtype
    )
    return robot, gripper, cfg


def asset_path(assets_dir: str, cfg: dict, key: str) -> str:
    """A config path (`.../data/<rel>`) in the asset tree."""
    return os.path.join(assets_dir, cfg[key].split("data/", 1)[-1])


def sim_robot_name(robot_name: str, cfg: dict) -> str:
    """The name the simulator's wrapper and the grasp files go by: synth7
    takes its config's (Panda conventions), the others their own."""
    return cfg["robot_name"] if robot_name == "synth7" else robot_name


def require_pybullet() -> None:
    """Exit as the JAX drivers do where no `pybullet` module is importable
    (a driver never installs the fake itself)."""
    try:
        import pybullet  # noqa: F401
    except ImportError:
        print("this driver needs pybullet (pip install pybullet)")
        sys.exit(1)


def clock(device) -> float:
    """Host clock after the device has finished the queued work."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()
