"""Render an object's grasp set as gripper ghosts (headless PNG), on the
port.

Port of examples/visualize_grasps.py (the reference's visualize_grasps.py)
through the port's viz/ (host matplotlib). Needs a SceneReplica grasp_data
tree (`-d`; testing.make_scenereplica_tree writes one for synth7).

    python -m grasptrajopt_tpu_torch.visualize_grasps -r synth7 --assets_dir TREE -m 009_gelatin_box --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from grasptrajopt_tpu_torch.envs.grasps import load_grasps
from grasptrajopt_tpu_torch.planning.utils import get_data_dir
from grasptrajopt_tpu_torch.spatial import r2quat
from grasptrajopt_tpu_torch.testing import SYNTH_SCENEREPLICA_CONFIG
from grasptrajopt_tpu_torch.utils.cli import build_models, resolve_device, sim_robot_name
from grasptrajopt_tpu_torch.viz import Visualizer


def make_args(argv=None):
    parser = argparse.ArgumentParser(description="Render an object's grasps as gripper ghosts")
    parser.add_argument("-r", "--robot", default="panda", help="panda, fetch or synth7")
    parser.add_argument("-d", "--data_dir", default=None, help="SceneReplica dataset root")
    parser.add_argument("-m", "--model", default="003_cracker_box")
    parser.add_argument("-n", "--num", type=int, default=8)
    parser.add_argument("-o", "--out", default="grasps.png")
    parser.add_argument("--assets_dir", default=None, help="robot data tree")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the gripper model's FK runs (cpu: float64)")
    return parser.parse_args(argv)


def main(argv=None):
    args = make_args(argv)
    device = resolve_device(args.device)
    assets_dir = args.assets_dir or get_data_dir()
    data_dir = args.data_dir or assets_dir
    _, gripper, cfg = build_models(args.robot, assets_dir, device=device, synth_config=SYNTH_SCENEREPLICA_CONFIG)

    RT_grasps = load_grasps(data_dir, sim_robot_name(args.robot, cfg), args.model)
    idx = np.linspace(0, RT_grasps.shape[0] - 1, min(args.num, RT_grasps.shape[0])).astype(int)

    vis = Visualizer(camera_position=[0.5, 0.5, 0.5])
    vis.grid_floor(extent=0.3)
    for RT in RT_grasps[idx]:
        quat = r2quat(torch.as_tensor(np.asarray(RT[:3, :3]), dtype=torch.float64)).numpy()
        vis.robot(
            gripper,
            q=cfg["gripper_open_offsets"],
            base_position=RT[:3, 3],
            base_orientation=quat,
            alpha=0.5,
        )
    vis.save(args.out)
    print(f"wrote {args.out}: {len(idx)} of {RT_grasps.shape[0]} grasps for {args.model}")
    return vis


if __name__ == "__main__":
    main()
