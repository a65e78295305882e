"""The port's viz layer (viz/visualizer.py, planning/debug_viz.py,
plot_kinematics) against the JAX package's, on the CPU: the same calls
on both packages' Visualizer give the same artists (scatter offsets,
line data, mesh polygons, texts, colors, alphas), on synth7's URDF and an
OBJ written here; robot_traj's alpha ramp; the five debug helpers on one
synth7 observation; the animation's frames pixel for pixel; and the
plot_kinematics CLI's duration."""

import os
import runpy
import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from mpl_toolkits.mplot3d.art3d import Path3DCollection, Poly3DCollection  # noqa: E402

import jax.numpy as jnp  # noqa: E402

import torch_parity  # noqa: E402
from grasptrajopt_tpu.models import RobotModel as JaxRobotModel  # noqa: E402
from grasptrajopt_tpu.planning import debug_viz as jax_debug_viz  # noqa: E402
from grasptrajopt_tpu.testing import make_synthetic_scene_field as jax_scene_field  # noqa: E402
from grasptrajopt_tpu.viz import Visualizer as JaxVisualizer  # noqa: E402
from grasptrajopt_tpu_torch.fields.depth_point_cloud import DepthPointCloud  # noqa: E402
from grasptrajopt_tpu_torch.models.robot import RobotModel  # noqa: E402
from grasptrajopt_tpu_torch.planning import debug_viz  # noqa: E402
from grasptrajopt_tpu_torch.testing import (  # noqa: E402
    SYNTH_DEFAULT_POSE,
    make_synthetic_gripper,
    make_synthetic_gto_robot,
    make_synthetic_scene_field,
)
from grasptrajopt_tpu_torch.viz import Visualizer  # noqa: E402

ATOL = 1e-9  # m: float64 FK of the two packages (their sin / cos may differ in the last bit)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STICK_URDF = """
<robot name="stick"><link name="a"/><link name="b"/>
  <joint name="j" type="revolute"><parent link="a"/><child link="b"/>
  <origin xyz="0 0 1"/><axis xyz="0 1 0"/>
  <limit lower="-1" upper="1" velocity="1"/></joint></robot>
"""


def artists(vis):
    """The axes' artists in drawing order, as comparable data."""
    out = []
    for c in vis.ax.collections:
        if isinstance(c, Path3DCollection):
            out.append(("scatter", [np.asarray(a) for a in c._offsets3d], c.get_sizes(), c.get_facecolors(),
                        c.get_alpha()))
        elif isinstance(c, Poly3DCollection):
            out.append(("polys", [np.asarray(c._vec)], [(s.start, s.stop) for s in c._segslices],
                        np.asarray(c._facecolor3d), c.get_alpha()))
        else:
            raise AssertionError(f"unexpected artist {type(c).__name__}")
    for line in vis.ax.lines:
        out.append(("line", [np.asarray(a) for a in line.get_data_3d()], line.get_color(), line.get_linewidth(),
                    line.get_alpha()))
    for t in vis.ax.texts:
        out.append(("text", [np.asarray([t._x, t._y, t._z], dtype=float)], t.get_text(), t.get_color(), None))
    return out


def assert_same_artists(a, b):
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert x[0] == y[0]
        assert len(x[1]) == len(y[1])
        for u, v in zip(x[1], y[1]):
            np.testing.assert_allclose(u, v, rtol=0, atol=ATOL)
        for u, v in zip(x[2:], y[2:]):
            if isinstance(u, np.ndarray):
                np.testing.assert_array_equal(u, v)
            else:
                assert u == v


def both(draw):
    """Run draw(Visualizer class, package tag) for each package; returns
    (jax artists, port artists), closing both figures."""
    got = []
    for cls, tag in ((JaxVisualizer, "jax"), (Visualizer, "port")):
        vis = cls()
        draw(vis, tag)
        got.append(artists(vis))
        vis.close()
    return got


@pytest.fixture(scope="module")
def synth():
    return {
        "jax": torch_parity.make_jax_synth_robot(points_per_link=2),
        "port": make_synthetic_gto_robot(device="cpu", dtype=torch.float64, points_per_link=2),
        "jax_gripper": torch_parity.make_jax_synth_gripper(points_per_link=2),
        "port_gripper": make_synthetic_gripper(device="cpu", dtype=torch.float64, points_per_link=2),
    }


def test_primitives_and_an_obj(tmp_path):
    obj = tmp_path / "tet.obj"
    obj.write_text("v 0 0 0\nv 0.2 0 0\nv 0 0.3 0\nv 0 0 0.1\nf 1 2 3\nf 1 2 4\nf 1 3 4\nf 2 3 4\n")
    T = np.eye(4)
    T[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    T[:3, 3] = [0.3, -0.1, 0.2]
    pts = np.random.default_rng(0).normal(size=(50, 3))

    def draw(vis, _):
        vis.grid_floor()
        vis.points(pts, rgb=[1, 0, 0], size=5)
        vis.line([0, 0, 0], [1, 1, 1])
        vis.sphere(radius=0.2, position=[0.5, 0, 0.5])
        vis.box(half_extents=[0.1, 0.1, 0.1], position=[0, 0.5, 0])
        vis.cylinder(radius=0.1, height=0.3, position=[-0.5, 0, 0])
        vis.text([0, 0, 1.2], "hello")
        vis.obj(str(obj), rgb=(0.2, 0.4, 0.6), alpha=0.5, transform=T)
        vis.stl(str(obj))

    assert_same_artists(*both(draw))
    vis = Visualizer()
    draw(vis, "port")
    out = tmp_path / "scene.png"
    vis.save(str(out))
    vis.close()
    assert out.exists() and out.stat().st_size > 1000


def test_synth7_robot_and_its_trajectory(synth):
    q = SYNTH_DEFAULT_POSE
    Q = np.tile(q[:, None], (1, 4))
    Q[0] = [-0.5, 0.0, 0.4, 0.9]
    Q[3] = [-1.4, -1.0, -0.6, -0.2]

    def draw(vis, tag):
        robot = synth[tag]
        vis.robot(robot, q=q)
        vis.robot(robot, q=q, base_position=[0.1, -0.2, 0.7], base_orientation=[0.1, 0.2, 0.3, 0.9], alpha=0.6)
        vis.robot(robot, q=q, base_orientation=[10, 20, 30], euler_degrees=True, rgb=(1, 0, 0))
        for style in ("A", "B", "C"):
            vis.robot_traj(robot, Q, alpha_spec={"style": style, "alpha": 0.3}, base_position=[0, 0, 0.7])

    jax_artists, port_artists = both(draw)
    assert_same_artists(jax_artists, port_artists)
    # robot_traj's ramps: each step draws one mesh per link with its alpha
    n_links = sum(1 for link in synth["port"].urdf.links if link.visual is not None)
    alphas = [a[4] for a in port_artists if a[0] == "polys"][3 * n_links:]
    want = np.concatenate([np.linspace(0.1, 1.0, 4), np.linspace(1.0, 0.1, 4), np.full(4, 0.3)])
    np.testing.assert_allclose(alphas, np.repeat(want, n_links), rtol=0, atol=0)


def test_skeleton_fallback():
    robots = {"jax": JaxRobotModel(urdf_string=STICK_URDF, dtype=jnp.float64),
              "port": RobotModel(urdf_string=STICK_URDF, dtype=torch.float64, device="cpu")}
    jax_artists, port_artists = both(lambda vis, tag: vis.robot(robots[tag], q=[0.3]))
    assert_same_artists(jax_artists, port_artists)
    assert [a[0] for a in port_artists] == ["line"]


def test_animation_frames_pixel_for_pixel(tmp_path):
    robots = {"jax": JaxRobotModel(urdf_string=STICK_URDF, dtype=jnp.float64),
              "port": RobotModel(urdf_string=STICK_URDF, dtype=torch.float64, device="cpu")}
    Q = np.linspace(-0.5, 0.5, 4)[None, :]
    frames, seen = {}, []
    for cls, tag in ((JaxVisualizer, "jax"), (Visualizer, "port")):
        vis = cls(window_size=(200, 150))
        vis.grid_floor()
        frames[tag] = vis.animate(robots[tag], Q, file_name=str(tmp_path / f"{tag}.gif"), fps=5,
                                  callback=lambda v, i, q: seen.append(i))
        vis.close()
    assert seen == [0, 1, 2, 3] * 2
    assert len(frames["port"]) == 4 and (tmp_path / "port.gif").stat().st_size > 500
    for a, b in zip(frames["jax"], frames["port"]):
        np.testing.assert_array_equal(a, b)


def test_debug_viz_helpers_on_a_synth7_observation(synth, monkeypatch, tmp_path):
    obs = torch_parity.observation("tabletop", size=48)
    depth_pc = DepthPointCloud(obs["depth"], obs["K"], obs["cam_pose"], device="cpu", dtype=torch.float64)
    base = obs["base_position"]
    RTs = obs["grasps_world"]
    field = make_synthetic_scene_field(synth["port"])
    np.testing.assert_array_equal(field, jax_scene_field(synth["jax"]))
    q = SYNTH_DEFAULT_POSE
    q_goal = q.copy()
    q_goal[:7] = [0.4, 0.9, -0.2, -1.0, 0.3, 1.5, 0.2]
    plan = q[:, None] + (q_goal - q)[:, None] * np.linspace(0.0, 1.0, 50)[None, :]
    cfg = {"gripper_open_offsets": [0.04, 0.04]}
    RT_off = RTs[0].copy()
    RT_off[:3, 3] -= 0.1 * RT_off[:3, 2]

    def calls(mod, robot, gripper):
        return [
            lambda: mod.visualize_pose(robot, base, q, depth_pc),
            lambda: mod.debug_plan(robot, gripper, base, plan, depth_pc, field, RT_grasps_world=RTs),
            lambda: mod.visualize_plan(robot, gripper, base, plan, depth_pc, RTs),
            lambda: mod.visualize_grasp(cfg, robot, gripper, base, q, depth_pc, RTs[0]),
            lambda: mod.visualize_standoff(cfg, gripper, RTs[0], RT_off),
        ]

    got = {}
    for mod, tag in ((jax_debug_viz, "jax"), (debug_viz, "port")):
        drawn = []
        monkeypatch.setattr(mod, "_finish", lambda vis, save_path: (drawn.append(artists(vis)), vis.close()))
        results = [f() for f in calls(mod, synth[tag], synth[f"{tag}_gripper"])]
        got[tag] = (drawn, results[1])
        monkeypatch.undo()
    assert len(got["port"][0]) == 5
    for a, b in zip(got["jax"][0], got["port"][0]):
        assert_same_artists(a, b)
    np.testing.assert_allclose(got["port"][1], got["jax"][1], rtol=1e-12, atol=1e-12)  # debug_plan's step costs
    assert len(got["port"][1]) == 5

    out = tmp_path / "pose.png"
    debug_viz.visualize_pose(synth["port"], base, q, depth_pc, save_path=str(out))
    assert out.exists() and out.stat().st_size > 1000


def test_plot_kinematics_cli(tmp_path, monkeypatch, capsys):
    """`python -m grasptrajopt_tpu_torch.plot_kinematics` against the JAX
    example (run here, in this process, as its __main__)."""
    out = tmp_path / "port.png"
    res = subprocess.run([sys.executable, "-m", "grasptrajopt_tpu_torch.plot_kinematics", "-o", str(out)],
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    port_line = res.stdout.strip().splitlines()[-1]
    monkeypatch.setattr(sys, "argv", ["plot_kinematics.py", "-o", str(tmp_path / "jax.png")])
    runpy.run_path(os.path.join(REPO, "examples", "plot_kinematics.py"), run_name="__main__")
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.stat().st_size > 1000
    assert port_line == f"wrote {out}; duration " + jax_line.split("; duration ")[1]
