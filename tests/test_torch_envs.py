"""The port's simulation layer (`grasptrajopt_tpu_torch.envs`: controllers,
grasps, fake_pybullet, pybullet_api, scene_replica) against the JAX
package's, on the CPU:

  - the controllers and the grasp loaders give the JAX package's arrays;
  - the port's fake camera round trip (tests/test_fake_pybullet.py's);
  - the `HAS_PYBULLET` gate flips when the port's fake is installed (in a
    fresh process);
  - `_mat2quat_wxyz` (the port's r2quat, float64) equals the JAX one on
    seeded rotations, angles near 180 degrees included;
  - `FixedBaseRobot` on the synthetic arm's URDF in both packages' fakes:
    the same plan gives the same joint and link states, and the link
    states equal the port's FK of the final configuration;
  - the Panda / Fetch wrappers need the robot data (skip without it).

Each package's `pybullet_api` binds the `pybullet` module that is
installed when it is imported; the fixture installs each package's fake
(force) before (re)loading that package's modules, and restores
`sys.modules["pybullet"]` afterwards.
"""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from grasptrajopt_tpu.envs import controllers as jax_controllers
from grasptrajopt_tpu.envs import fake_pybullet as jax_fp
from grasptrajopt_tpu.envs import grasps as jax_grasps
from grasptrajopt_tpu_torch.envs import controllers, grasps
from grasptrajopt_tpu_torch.envs import fake_pybullet as fp
from grasptrajopt_tpu_torch.testing import SYNTH_ARM_URDF, SYNTH_DEFAULT_POSE, make_synthetic_gto_robot
from fake_dataset import write_box_urdf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def sims():
    """(port pybullet_api, port scene_replica, JAX pybullet_api), each
    bound to its own package's fake."""
    previous = sys.modules.get("pybullet")
    assert fp.install(force=True)
    port_api = importlib.reload(importlib.import_module("grasptrajopt_tpu_torch.envs.pybullet_api"))
    port_sr = importlib.reload(importlib.import_module("grasptrajopt_tpu_torch.envs.scene_replica"))
    assert port_api.p is fp
    assert jax_fp.install(force=True)
    jax_api = importlib.reload(importlib.import_module("grasptrajopt_tpu.envs.pybullet_api"))
    assert jax_api.p is jax_fp
    yield port_api, port_sr, jax_api
    fp.disconnect()
    jax_fp.disconnect()
    if previous is None:
        sys.modules.pop("pybullet", None)
    else:
        sys.modules["pybullet"] = previous


@pytest.fixture()
def fresh_worlds():
    fp.resetSimulation()
    jax_fp.resetSimulation()
    yield


def test_controllers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-20, 20, size=50)
    for kw in ({}, {"zero_2_2pi": True}, {"degree": True}, {"zero_2_2pi": True, "degree": True}):
        np.testing.assert_array_equal(controllers.angle_mod(x, **kw), jax_controllers.angle_mod(x, **kw))
        assert controllers.angle_mod(7.5, **kw) == jax_controllers.angle_mod(7.5, **kw)
    a, b = controllers.PathFinderController(1, 1, 3), jax_controllers.PathFinderController(1, 1, 3)
    for dx, dy, th in rng.uniform(-2, 2, size=(20, 3)):
        assert a.calc_control_xy(dx, dy, th) == b.calc_control_xy(dx, dy, th)
        assert a.calc_control_theta(th, dx) == b.calc_control_theta(th, dx)
    for v, w in rng.uniform(-1, 1, size=(10, 2)):
        np.testing.assert_array_equal(
            controllers.diff_drive_wheel_velocities(v, w), jax_controllers.diff_drive_wheel_velocities(v, w)
        )


def test_grasp_loaders_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    poses = []
    for _ in range(5):
        q = rng.normal(size=4)
        poses.append({"pose": list(rng.uniform(-1, 1, size=3)) + list(q / np.linalg.norm(q))})
    refined = tmp_path / "grasp_data" / "refined_grasps"
    refined.mkdir(parents=True)
    (refined / "fetch_gripper-003_cracker_box.json").write_text(json.dumps({"grasps": poses}))
    sim = tmp_path / "grasp_data" / "panda_simulated"
    sim.mkdir()
    np.save(sim / "003_cracker_box.npy", {"transforms": rng.normal(size=(4, 4, 4))}, allow_pickle=True)
    got = grasps.parse_grasps(str(refined / "fetch_gripper-003_cracker_box.json"))
    np.testing.assert_array_equal(got, jax_grasps.parse_grasps(str(refined / "fetch_gripper-003_cracker_box.json")))
    assert got.shape == (5, 4, 4) and got.dtype == np.float32
    for robot in ("fetch", "panda"):
        np.testing.assert_array_equal(
            grasps.load_grasps(str(tmp_path), robot, "003_cracker_box"),
            jax_grasps.load_grasps(str(tmp_path), robot, "003_cracker_box"),
        )
    with pytest.raises(ValueError):
        grasps.load_grasps(str(tmp_path), "synth7", "003_cracker_box")


def test_fake_camera_roundtrip(sims, fresh_worlds, tmp_path):
    """getCameraImage's NDC depth -> depth_from_ndc recovers the metric
    depth of a box in front of the camera."""
    from grasptrajopt_tpu_torch.envs.camera import depth_from_ndc, se3_inverse
    from grasptrajopt_tpu_torch.envs.render import look_at_pose

    box = str(tmp_path / "_fake_box.urdf")
    write_box_urdf(box, 0.4, 0.4, 0.4)
    fp.loadURDF(fileName=box, basePosition=[1.0, 0.0, 0.0])
    near, far = 0.1, 10.0
    proj = fp.computeProjectionMatrixFOV(45, 320 / 240, near, far)
    cam_pose = look_at_pose([0.0, 0.0, 0.0], [1.0, 0.0, 0.0])
    flip = np.eye(4)
    flip[1, 1] = flip[2, 2] = -1.0
    view = se3_inverse(cam_pose @ flip).T.flatten().tolist()
    w, h, rgba, ndc, mask = fp.getCameraImage(width=320, height=240, viewMatrix=view, projectionMatrix=proj)
    assert rgba.shape == (240, 320, 4) and mask.shape == (240, 320)
    depth = depth_from_ndc(ndc, near, far)
    assert abs(depth[120, 160] - 0.8) < 0.01  # the box's front face at x = 0.8
    assert mask[120, 160] == 0
    assert depth[0, 0] == pytest.approx(far, rel=1e-5)  # FAR background
    assert mask[0, 0] == -1
    jax_fp.loadURDF(fileName=box, basePosition=[1.0, 0.0, 0.0])
    want = jax_fp.getCameraImage(width=320, height=240, viewMatrix=view, projectionMatrix=proj)
    for a, b in zip((rgba, ndc, mask), want[2:]):
        np.testing.assert_array_equal(a, b)


def test_env_gate_flips_with_the_port_fake():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "import grasptrajopt_tpu_torch.envs as E\n"
        "assert not E.HAS_PYBULLET\n"
        "from grasptrajopt_tpu_torch.envs import fake_pybullet as fp\n"
        "assert fp.install()\n"
        "import pybullet\n"
        "E = importlib.reload(E)\n"
        "assert E.HAS_PYBULLET\n"
        "from grasptrajopt_tpu_torch.envs import Fetch, FixedBaseRobot, Panda, PyBulletSession, SceneReplicaEnv\n"
        "print('gate-ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "gate-ok" in out.stdout


def _rotation(axis, angle):
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def test_mat2quat_matches_jax(sims):
    import grasptrajopt_tpu.envs.scene_replica as jax_sr

    _, port_sr, _ = sims
    rng = np.random.default_rng(4)
    angles = list(rng.uniform(-np.pi, np.pi, size=20)) + [np.pi, np.pi - 1e-9, -np.pi + 1e-7, 0.0, 1e-9]
    for angle in angles:
        R = _rotation(rng.normal(size=3), angle)
        got, want = port_sr._mat2quat_wxyz(R), jax_sr._mat2quat_wxyz(R)
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
        assert abs(np.linalg.norm(got) - 1.0) < 1e-9
    for R in (np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]), np.diag([-1.0, -1.0, 1.0])):
        np.testing.assert_allclose(port_sr._mat2quat_wxyz(R), jax_sr._mat2quat_wxyz(R), atol=1e-12, rtol=0)


def _quat_xyzw_to_matrix(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def test_fixed_base_robot_executes_a_synth7_plan_in_both_fakes(sims, fresh_worlds, tmp_path):
    port_api, _, jax_api = sims
    urdf = tmp_path / "synth7.urdf"
    urdf.write_text(SYNTH_ARM_URDF)
    port_robot, jax_robot = port_api.FixedBaseRobot(str(urdf)), jax_api.FixedBaseRobot(str(urdf))
    assert port_robot.ndof == jax_robot.ndof == 9
    assert port_robot._actuated_joint_names == jax_robot._actuated_joint_names
    model = make_synthetic_gto_robot(device="cpu", dtype=torch.float64, points_per_link=1)
    assert port_robot._actuated_joint_names == model.actuated_joint_names
    q0 = SYNTH_DEFAULT_POSE.copy()
    q1 = q0 + np.concatenate([np.random.default_rng(5).uniform(-0.4, 0.4, size=7), [-0.02, -0.02]])
    plan = np.linspace(q0, q1, 12).T  # (9, 12)
    for robot in (port_robot, jax_robot):
        robot.reset(q0)
        robot.execute_plan(plan)
    np.testing.assert_array_equal(port_robot.q(), jax_robot.q())
    np.testing.assert_allclose(port_robot.q(), q1, atol=1e-9)
    frames = model.fk_all(torch.as_tensor(np.asarray(port_robot.q()))).numpy()
    for link in range(fp.getNumJoints(port_robot._id)):
        got = fp.getLinkState(port_robot._id, link)
        assert got == jax_fp.getLinkState(jax_robot._id, link)
        name = fp.getJointInfo(port_robot._id, link)[12].decode()
        T = frames[model.frame_of(name)]
        np.testing.assert_allclose(got[0], T[:3, 3], atol=1e-12)
        np.testing.assert_allclose(_quat_xyzw_to_matrix(got[1]), T[:3, :3], atol=1e-12)


def test_panda_wrapper(sims, fresh_worlds, data_dir):
    port_api = sims[0]
    sess = port_api.PyBulletSession(dt=0.02, add_floor=True, gui=False)
    robot = port_api.Panda(os.path.join(data_dir, "robots", "panda", "panda.urdf"))
    assert robot.ndof == 9
    q0 = robot.default_pose()
    robot.reset(q0)
    np.testing.assert_allclose(robot.q(), q0, atol=1e-12)
    q1 = q0.copy()
    q1[0] += 0.3
    robot.execute_plan(np.linspace(q0, q1, 8).T, num=30)
    np.testing.assert_allclose(robot.q(), q1, atol=1e-6)
    robot.close_gripper()
    assert robot.q()[-1] == pytest.approx(0.0, abs=1e-8)
    view, pose = robot.get_camera_pose()
    assert len(view) == 16 and pose.shape == (4, 4)
    sess.close()


def test_fetch_wrapper_and_base_driving(sims, fresh_worlds, data_dir):
    port_api = sims[0]
    robot = port_api.Fetch(os.path.join(data_dir, "robots", "fetch", "fetch.urdf"), fix_base=0)
    assert robot.ndof == 15
    robot.reset(robot.default_pose())
    robot.look_at(10.0, 20.0)
    assert robot.q()[3] == pytest.approx(np.radians(10.0), abs=1e-6)
    fp.setRealTimeSimulation(1)
    robot.move_to_xy(0.05, 0.0)
    x, y, _ = robot.get_base_pose()
    assert abs(x - 0.05) < 0.02 and abs(y) < 0.02
    fp.setRealTimeSimulation(0)
