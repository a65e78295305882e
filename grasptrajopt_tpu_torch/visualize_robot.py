"""Render a robot model and its surface point cloud to a PNG, on the port.

Port of examples/visualize_robot.py (the reference's visualize_robot.py /
test_mesh_to_sdf.py viewers), headless through the port's viz/ (host
matplotlib): writes robot.png instead of opening a window.

    python -m grasptrajopt_tpu_torch.visualize_robot -r synth7 --device cpu
"""

from __future__ import annotations

import argparse

from grasptrajopt_tpu_torch.planning.utils import default_pose, get_data_dir
from grasptrajopt_tpu_torch.testing import SYNTH_SCENEREPLICA_CONFIG
from grasptrajopt_tpu_torch.utils.cli import build_models, resolve_device
from grasptrajopt_tpu_torch.viz import Visualizer


def make_args(argv=None):
    parser = argparse.ArgumentParser(description="Render a robot and its surface points")
    parser.add_argument("-r", "--robot", default="panda", help="panda, fetch or synth7")
    parser.add_argument("-o", "--out", default="robot.png")
    parser.add_argument("--assets_dir", default=None, help="robot data tree (not needed for synth7)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the robot model's FK runs (cpu: float64)")
    return parser.parse_args(argv)


def main(argv=None):
    args = make_args(argv)
    device = resolve_device(args.device)
    robot, _, _ = build_models(args.robot, args.assets_dir or get_data_dir(), device=device, synth_config=SYNTH_SCENEREPLICA_CONFIG)
    q = default_pose(robot)

    pts = robot.compute_fk_surface_points(q)
    vis = Visualizer(camera_position=[3, 0, 3])
    vis.grid_floor()
    vis.points(pts, rgb=[1, 0, 0], size=5)
    vis.robot(robot, q=q, alpha=0.5)
    vis.save(args.out)
    print(f"wrote {args.out}: {robot.name}, {pts.shape[0]} surface points")
    return vis


if __name__ == "__main__":
    main()
