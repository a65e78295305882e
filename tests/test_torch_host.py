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

    from grasptrajopt_tpu_torch import convert
    from grasptrajopt_tpu_torch.models.robot import RobotModel
    from grasptrajopt_tpu_torch.planning.gto_models import GTORobotModel

    for fn in (
        RobotModel.__init__, GTORobotModel.__init__, GTORobotModel.from_urdf_string, port_synth,
        convert.robot_from_numpy, convert.scene_sets_from_numpy, convert.params_from_numpy,
    ):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__


def test_port_imports_without_jax():
    """Every module of the port imports with `jax` blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import grasptrajopt_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 30
