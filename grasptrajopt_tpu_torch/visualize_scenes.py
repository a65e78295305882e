"""Render a SceneReplica-style scene: furniture, objects, the robot at its
default pose and sample grasps per object as gripper ghosts (headless
PNG), on the port.

Port of examples/visualize_scenes.py through the port's viz/ (host
matplotlib): the synthetic SceneReplica-style scenes of envs/synthetic.py
(YCB-dimensioned primitives, analytic antipodal grasp sets), the scene
generator of the closed-loop harness.

    python -m grasptrajopt_tpu_torch.visualize_scenes -r synth7 -t tabletop --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from grasptrajopt_tpu_torch.envs.synthetic import SyntheticSceneEnv
from grasptrajopt_tpu_torch.planning.utils import default_pose, get_data_dir
from grasptrajopt_tpu_torch.spatial import r2quat
from grasptrajopt_tpu_torch.testing import SYNTH_SCENEREPLICA_CONFIG
from grasptrajopt_tpu_torch.utils.cli import build_models, resolve_device, sim_robot_name
from grasptrajopt_tpu_torch.viz import Visualizer


def make_args(argv=None):
    parser = argparse.ArgumentParser(description="Visualize a synthetic scene")
    parser.add_argument("-r", "--robot", default="panda", help="panda, fetch or synth7")
    parser.add_argument("-s", "--scene_id", type=int, default=10)
    parser.add_argument("-t", "--scene_type", default="tabletop", choices=["tabletop", "shelf"])
    parser.add_argument("-n", "--n_objects", type=int, default=5)
    parser.add_argument("-g", "--grasps_per_object", type=int, default=3)
    parser.add_argument("-o", "--out", default="scene.png")
    parser.add_argument("--assets_dir", default=None, help="robot data tree (not needed for synth7)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the models' FK runs (cpu: float64)")
    return parser.parse_args(argv)


def main(argv=None):
    args = make_args(argv)
    device = resolve_device(args.device)
    robot, gripper, cfg = build_models(args.robot, args.assets_dir or get_data_dir(), device=device, synth_config=SYNTH_SCENEREPLICA_CONFIG)

    env = SyntheticSceneEnv(
        robot_name=sim_robot_name(args.robot, cfg), scene_type=args.scene_type, n_objects=args.n_objects
    )
    meta = env.setup_scene(args.scene_id)
    rng = np.random.default_rng(args.scene_id)

    vis = Visualizer(camera_position=[1.6, 1.6, 1.5])
    for mesh, pose, _uid in env._static_meshes:
        verts = mesh.vertices @ pose[:3, :3].T + pose[:3, 3]
        vis.mesh(verts, mesh.faces, rgb=(0.55, 0.4, 0.25), alpha=0.35)

    print(f"----------- scene {args.scene_id} ({args.scene_type}) -----------")
    for placed in env.objects:
        mesh = placed.obj.mesh
        verts = mesh.vertices @ placed.pose[:3, :3].T + placed.pose[:3, 3]
        vis.mesh(verts, mesh.faces, rgb=(0.2, 0.5, 0.8), alpha=1.0)
        print(placed.obj.name, placed.pose[:3, 3])

        RT_world = env.grasps_world(placed.obj.name)
        idx = rng.choice(RT_world.shape[0], min(args.grasps_per_object, RT_world.shape[0]), replace=False)
        for RT in RT_world[idx]:
            quat = r2quat(torch.as_tensor(np.asarray(RT[:3, :3]), dtype=torch.float64)).numpy()
            vis.robot(
                gripper,
                q=cfg["gripper_open_offsets"],
                base_position=RT[:3, 3],
                base_orientation=quat,
                alpha=0.35,
            )

    vis.robot(robot, q=default_pose(robot), base_position=env.base_position)
    vis.save(args.out)
    print(f"wrote {args.out}: {len(env.objects)} objects ({meta['object_names']})")
    return vis


if __name__ == "__main__":
    main()
