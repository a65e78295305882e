"""The port's host copies against the JAX package's originals (exact), and
the port's import hygiene (no JAX anywhere in grasptrajopt_tpu_torch)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)

from grasptrajopt_tpu.envs.synthetic import SyntheticSceneEnv as JaxEnv
from grasptrajopt_tpu.fields.surface_point_cloud import SurfacePointCloud as JaxSPC
from grasptrajopt_tpu.models.mesh import box_mesh as jax_box
from grasptrajopt_tpu.models.urdf import parse_urdf_string as jax_parse
from grasptrajopt_tpu.testing import SYNTH_ARM_URDF as JAX_URDF
from grasptrajopt_tpu.testing import make_synthetic_gto_robot as jax_synth
from grasptrajopt_tpu_torch.envs.synthetic import SyntheticSceneEnv as PortEnv
from grasptrajopt_tpu_torch.fields.surface_point_cloud import SurfacePointCloud as PortSPC
from grasptrajopt_tpu_torch.models.mesh import box_mesh as port_box
from grasptrajopt_tpu_torch.models.urdf import parse_urdf_string as port_parse
from grasptrajopt_tpu_torch.testing import SYNTH_ARM_URDF as PORT_URDF
from grasptrajopt_tpu_torch.testing import make_synthetic_gto_robot as port_synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_synth_urdf_parses_identically():
    assert PORT_URDF == JAX_URDF
    a, b = jax_parse(JAX_URDF), port_parse(PORT_URDF)
    assert a.name == b.name
    assert [dataclasses.asdict(l) for l in a.links] == [dataclasses.asdict(l) for l in b.links]
    assert [dataclasses.asdict(j) for j in a.joints] == [dataclasses.asdict(j) for j in b.joints]


@pytest.mark.parametrize("points_per_link", [10, 100])
def test_synthetic_robot_surface_points_bit_identical(points_per_link):
    """crc32-seeded sampling in the copied mesh module gives the same
    points and normals, so both packages compute on identical bodies."""
    jr = jax_synth(points_per_link=points_per_link)
    pr = port_synth(device="cpu", dtype=torch.float64, points_per_link=points_per_link)
    assert list(jr.surface_pc_map) == list(pr.surface_points)
    for name, pc in jr.surface_pc_map.items():
        np.testing.assert_array_equal(pc.points, pr.surface_points[name])
        np.testing.assert_array_equal(pc.normals, pr.surface_normals[name])
        np.testing.assert_array_equal(jr._visual_offsets[name], pr.visual_offsets[name])
    assert jr.num_surface_points == pr.num_surface_points == 10 * points_per_link
    assert (jr.grid.origin, jr.grid.shape, jr.grid.resolution) == (
        pr.grid.origin, pr.grid.shape, pr.grid.resolution
    )
    np.testing.assert_array_equal(jr.grid.grid_points(), pr.grid.grid_points())


def test_surface_point_cloud_sdf_matches():
    """The copied SurfacePointCloud on the same sampled box: signed
    distances and gradients equal to the original's."""
    box = jax_box((0.1, 0.2, 0.05))
    pts, nrm = box.sample_surface(500, seed=3)
    q = np.random.default_rng(5).uniform(-0.2, 0.2, size=(300, 3))
    want = JaxSPC(box, pts, nrm).get_sdf(q, return_gradients=True)
    got = PortSPC(port_box((0.1, 0.2, 0.05)), pts, nrm).get_sdf(q, return_gradients=True)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert (want[0] < 0).any() and (want[0] > 0).any()


def test_render_depth_scene36_matches():
    """96x96 observation of scene 36: the port's numpy rasterizer against
    the JAX package's renderer, to 1e-6 m with identical object ids."""
    ej = JaxEnv(robot_name="panda", scene_type="tabletop", n_objects=5, width=96, height=96)
    ep = PortEnv(robot_name="panda", scene_type="tabletop", n_objects=5, width=96, height=96)
    assert ej.setup_scene(36) == ep.setup_scene(36)
    dj, ij, pj, Kj = ej.get_observation()
    dp, ip, pp, Kp = ep.get_observation()
    np.testing.assert_array_equal(pj, pp)
    np.testing.assert_array_equal(Kj, Kp)
    bad = np.argwhere(np.abs(dj - dp) > 1e-6)
    assert bad.size == 0, f"depth differs at pixels {bad[:10].tolist()}"
    np.testing.assert_array_equal(ij, ip)
    for name in ej.meta["object_names"]:
        np.testing.assert_array_equal(ej.grasps_world(name, 32), ep.grasps_world(name, 32))


def test_entry_points_default_to_the_card():
    """Every entry point that places tensors runs on the card unless the
    caller asks for the CPU (the CPU tests pass device="cpu")."""
    import inspect

    from grasptrajopt_tpu_torch import convert, synthetic_eval, synthetic_eval_mobile, throughput_serving
    from grasptrajopt_tpu_torch.fields.depth_point_cloud import DepthPointCloud
    from grasptrajopt_tpu_torch.models.robot import RobotModel
    from grasptrajopt_tpu_torch.planning.gto_models import GTORobotModel
    from grasptrajopt_tpu_torch.testing import make_synthetic_gripper

    for fn in (
        RobotModel.__init__, GTORobotModel.__init__, GTORobotModel.from_urdf_string, port_synth,
        convert.robot_from_numpy, convert.scene_sets_from_numpy, convert.params_from_numpy,
        DepthPointCloud.__init__, make_synthetic_gripper, synthetic_eval.build_models,
        throughput_serving.Server.__init__,
    ):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    assert synthetic_eval.make_args([]).device == "cuda"
    assert synthetic_eval_mobile.make_args([]).device == "cuda"
    assert throughput_serving.make_args([]).device == "cuda"


def test_build_models_picks_the_dtype_of_its_device():
    """synthetic_eval.build_models with no dtype: float64 on the CPU (and
    float32 on the card, where K4 takes float32 only: the `gpu` trial
    test builds from the defaults)."""
    from grasptrajopt_tpu_torch.synthetic_eval import build_models
    from grasptrajopt_tpu_torch.testing import SYNTH_EVAL_CONFIG

    robot, gripper, cfg = build_models("synth7", grid_resolution=0.1, device="cpu")
    assert robot.dtype == gripper.dtype == torch.float64
    assert robot.device.type == gripper.device.type == "cpu"
    assert robot.grid.resolution == 0.1 and cfg == SYNTH_EVAL_CONFIG


SERVING_AND_SIMULATION_MODULES = (
    "parallel", "parallel.streaming", "throughput_serving", "utils.profiling", "planning.retiming", "native",
    "envs.controllers", "envs.grasps", "envs.fake_pybullet", "envs.pybullet_api", "envs.scene_replica",
)


def test_port_imports_without_jax():
    """Every module of the port imports with `jax` blocked (the simulation
    layer's modules against the port's own fake `pybullet`)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import grasptrajopt_tpu_torch as P\n"
        "from grasptrajopt_tpu_torch.envs import fake_pybullet\n"
        "assert fake_pybullet.install()\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
        "assert not any(k.startswith('grasptrajopt_tpu.') or k == 'grasptrajopt_tpu' for k in sys.modules)\n"
        "print(' '.join(names))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 55
    for name in SERVING_AND_SIMULATION_MODULES:
        assert f"grasptrajopt_tpu_torch.{name}" in names, name


def test_synthetic_gripper_matches_the_arm_and_jax():
    """The gripper model samples the arm's hand and finger points (seeded
    by link name); its surface points at the open offsets equal the JAX
    package's model of the same URDF string, and so does the standoff
    pose."""
    from grasptrajopt_tpu.planning.gto_models import GTORobotModel as JaxModel
    from grasptrajopt_tpu_torch.testing import SYNTH_EVAL_CONFIG, SYNTH_GRIPPER_URDF, make_synthetic_gripper

    import jax.numpy as jnp

    gripper = make_synthetic_gripper(device="cpu", dtype=torch.float64, points_per_link=10)
    arm = port_synth(device="cpu", dtype=torch.float64, points_per_link=10)
    assert list(gripper.surface_points) == ["hand", "finger_l", "finger_r"]
    for name, pts in gripper.surface_points.items():
        np.testing.assert_array_equal(pts, arm.surface_points[name])
    jg = JaxModel(model_dir="", urdf_string=SYNTH_GRIPPER_URDF, points_per_link=10, dtype=jnp.float64)
    offsets = np.asarray(SYNTH_EVAL_CONFIG["gripper_open_offsets"])
    got = gripper.compute_fk_surface_points(offsets)
    assert got.shape == (30, 3)
    np.testing.assert_allclose(got, jg.compute_fk_surface_points(offsets)[0], atol=1e-12, rtol=0)
    np.testing.assert_array_equal(gripper.get_standoff_pose(-0.01, "z"), jg.get_standoff_pose(-0.01, "z"))


def test_rotz_and_default_pose_match_jax():
    """planning/utils.py's host copies: rotZ bit-identical, and
    default_pose zeros for synth7 (fetch and panda only have a canonical
    pose), as the JAX mobile harness starts its base solve from it."""
    from types import SimpleNamespace

    from grasptrajopt_tpu.planning.utils import default_pose as jax_default_pose
    from grasptrajopt_tpu.planning.utils import rotZ as jax_rotZ
    from grasptrajopt_tpu_torch.planning.utils import default_pose, rotZ

    for theta in (0.0, 0.3, -2.5, np.pi):
        np.testing.assert_array_equal(rotZ(theta), jax_rotZ(theta))
    robot = port_synth(device="cpu", dtype=torch.float64, points_per_link=1)
    assert robot.name == "synth7"
    np.testing.assert_array_equal(default_pose(robot), np.zeros(9, np.float32))
    for name, ndof in (("synth7", 9), ("panda", 9), ("fetch", 14)):
        model = SimpleNamespace(name=name, ndof=ndof)
        got, want = default_pose(model), jax_default_pose(model)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
