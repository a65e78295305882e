"""Replay recorded plans in the simulator and write videos, on the port.

Port of examples/save_videos.py (the reference's pybullet_save_videos.py):
loads a result file, replays each plan in the simulator and writes one
mp4 per scene and ordering through OpenCV. Needs a `pybullet` module and
`cv2`; no solve runs, so there is no device choice.

    python -m grasptrajopt_tpu_torch.save_videos -r synth7 --assets_dir TREE -f RESULT.json -o videos
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from grasptrajopt_tpu_torch.planning.utils import get_data_dir
from grasptrajopt_tpu_torch.testing import SYNTH_SCENEREPLICA_CONFIG
from grasptrajopt_tpu_torch.utils.cli import asset_path, require_pybullet, robot_config, sim_robot_name
from grasptrajopt_tpu_torch.utils.results import load_results


def make_args(argv=None):
    parser = argparse.ArgumentParser(description="Replay recorded plans into videos")
    parser.add_argument("-r", "--robot", default="panda", help="panda, fetch or synth7")
    parser.add_argument("-d", "--data_dir", default=None)
    parser.add_argument("-t", "--scene_type", default="tabletop")
    parser.add_argument("-f", "--file", required=True)
    parser.add_argument("-o", "--outdir", default="videos")
    parser.add_argument("--assets_dir", default=None)
    return parser.parse_args(argv)


def main(argv=None):
    """Returns the video files written."""
    args = make_args(argv)
    require_pybullet()
    try:
        import cv2
    except ImportError:
        print("this driver needs opencv-python (cv2) for video writing")
        sys.exit(1)

    import pybullet as p

    from grasptrajopt_tpu_torch.envs.scene_replica import SceneReplicaEnv

    assets_dir = args.assets_dir or get_data_dir()
    data_dir = args.data_dir or assets_dir
    cfg = robot_config(args.robot, assets_dir, SYNTH_SCENEREPLICA_CONFIG)
    env = SceneReplicaEnv(
        asset_path(assets_dir, cfg, "urdf_robot_path"), data_dir, assets_dir,
        sim_robot_name(args.robot, cfg), args.scene_type,
    )
    results_scene = load_results(args.file)
    os.makedirs(args.outdir, exist_ok=True)

    W, H = env._window_width, env._window_height
    view = p.computeViewMatrixFromYawPitchRoll([0.8, 0, 0.8], 1.8, 15.0, -41.0, 0, 2)
    proj = p.computeProjectionMatrixFOV(60.0, W / H, 0.1, 10)

    written = []
    for scene_id, orderings in results_scene.items():
        meta = env.setup_scene(int(scene_id))
        for ordering, results in orderings.items():
            if ordering == "RT_base_new":
                continue
            object_order = meta[ordering][0].split(",")
            out = os.path.join(args.outdir, f"scene{scene_id}_{ordering}.mp4")
            writer = cv2.VideoWriter(out, cv2.VideoWriter_fourcc(*"mp4v"), 25, (W, H))
            set_objects = set(object_order)
            for object_name in object_order:
                rec = results.get(object_name, {})
                env.reset_scene(set_objects)
                if rec.get("plan") is not None:
                    plan = np.asarray(rec["plan"])
                    for t in range(plan.shape[1]):
                        env.robot.cmd(plan[:, t])
                        for _ in range(200):
                            p.stepSimulation()
                        _, _, rgba, _, _ = p.getCameraImage(W, H, viewMatrix=view, projectionMatrix=proj)
                        writer.write(np.asarray(rgba)[:, :, [2, 1, 0]].astype(np.uint8))
                env.reset_objects(object_name)
                env.robot.retract()
                set_objects.remove(object_name)
            writer.release()
            written.append(out)
            print("wrote", out)
    return written


if __name__ == "__main__":
    main()
