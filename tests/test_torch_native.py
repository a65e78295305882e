"""The port's geomcore library (`grasptrajopt_tpu_torch.native`, built
from csrc/geomcore.cpp into the port's _build/) against the JAX
package's (native/geomcore.cpp): mesh loading, rasterizing and KD-tree
queries give the same arrays; the port's render_depth and load_mesh give
the same output through the library and through the numpy fallback. Skips
where g++ is absent."""

import shutil
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
from scipy.spatial import cKDTree

from grasptrajopt_tpu import native as jax_native
from grasptrajopt_tpu_torch import native
from grasptrajopt_tpu_torch.envs.render import look_at_pose, render_depth
from grasptrajopt_tpu_torch.envs.synthetic import SyntheticSceneEnv
from grasptrajopt_tpu_torch.models import mesh as port_mesh


@pytest.fixture(scope="module")
def libs():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available: the native library cannot be built")
    assert native.is_available() and jax_native.is_available()
    return native, jax_native


def test_the_port_builds_its_own_library(libs):
    lib = Path(native.__file__).resolve().parents[1] / "_build" / "libgeomcore.so"
    assert lib.exists()
    assert native._lib._name == str(lib)


def _write_meshes(tmp_path):
    """A sphere as OBJ (with a quad face to triangulate) and a box as
    binary STL, written by hand."""
    sphere = port_mesh.sphere_mesh(0.1, subdiv=2)
    obj = tmp_path / "sphere.obj"
    lines = [f"v {x:.9f} {y:.9f} {z:.9f}" for x, y, z in sphere.vertices]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in sphere.faces]
    n = len(sphere.vertices)
    lines += [f"v 1 0 0", "v 1 1 0", "v 0 1 0", "v 0 0 0", f"f {n + 1} {n + 2} {n + 3} {n + 4}"]
    obj.write_text("\n".join(lines) + "\n")
    box = port_mesh.box_mesh((0.1, 0.2, 0.3))
    tris = box.vertices[box.faces].astype(np.float32)
    stl = tmp_path / "box.stl"
    with open(stl, "wb") as f:
        f.write(b"\0" * 80 + np.uint32(len(tris)).tobytes())
        for tri in tris:
            f.write(np.zeros(3, np.float32).tobytes() + tri.tobytes() + b"\0\0")
    return str(obj), str(stl)


def test_mesh_loading_matches_jax_and_the_python_loaders(libs, tmp_path):
    for path in _write_meshes(tmp_path):
        got, want = native.load_mesh_native(path), jax_native.load_mesh_native(path)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert got[0].dtype == np.float64 and got[1].dtype == np.int32
        py = port_mesh.load_mesh(path, prefer_native=False)
        via = port_mesh.load_mesh(path)
        np.testing.assert_array_equal(via.vertices, got[0])
        np.testing.assert_array_equal(via.faces, got[1])
        np.testing.assert_allclose(py.vertices, got[0], atol=1e-6)
        np.testing.assert_array_equal(py.faces, got[1])
    assert native.load_mesh_native(str(tmp_path / "mesh.ply")) is None


def test_rasterize_matches_jax(libs):
    rng = np.random.default_rng(2)
    verts = rng.uniform([-0.5, -0.5, 0.5], [0.5, 0.5, 2.0], size=(60, 3))
    faces = rng.integers(0, 60, size=(40, 3)).astype(np.int32)
    outs = []
    for lib in (native, jax_native):
        depth = np.full((48, 64), np.inf, np.float32)
        ids = np.full((48, 64), -1, np.int32)
        face = np.full((48, 64), -1, np.int32)
        assert lib.rasterize_native(verts, faces, 50.0, 50.0, 32.0, 24.0, 64, 48, 7, depth, ids, face)
        outs.append((depth, ids, face))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert (outs[0][1] == 7).sum() > 100
    with pytest.raises(ValueError):
        native.rasterize_native(verts, faces, 50.0, 50.0, 32.0, 24.0, 64, 48, 7,
                                np.zeros((48, 64), np.float64), np.zeros((48, 64), np.int32))


def test_kdtree_matches_jax_and_scipy(libs):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(20000, 3))  # > 4096 queries: the threaded path
    queries = rng.normal(size=(9000, 3))
    d, i = native.NativeKDTree(pts).query(queries)
    dj, ij = jax_native.NativeKDTree(pts).query(queries)
    np.testing.assert_array_equal(d, dj)
    np.testing.assert_array_equal(i, ij)
    want_d, want_i = cKDTree(pts).query(queries)
    np.testing.assert_allclose(d, want_d, atol=1e-12)
    np.testing.assert_array_equal(i, want_i)


def test_render_depth_native_equals_numpy(libs):
    env = SyntheticSceneEnv(robot_name="panda", scene_type="shelf", n_objects=5, width=80, height=64)
    env.setup_scene(10)
    env.reset_scene()
    cam = env.camera_poses(1)[0]
    got = env.get_observation(cam)
    with mock.patch.object(native, "rasterize_native", lambda *a, **k: False):
        want = env.get_observation(cam)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (got[1] >= 0).sum() > 100 and (got[1] < -1).sum() > 100  # objects and the shelf
    # near-plane culling and per-pixel faces
    box = port_mesh.box_mesh((0.4, 0.4, 0.4))
    pose = np.eye(4)
    pose[:3, 3] = [0.3, 0.0, 0.0]
    args = ([(box, pose, 3)], look_at_pose([0.0, 0.0, 0.0], [1.0, 0.0, 0.0]),
            np.array([[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]]), 64, 48)
    got = render_depth(*args, with_faces=True, znear=0.15)
    with mock.patch.object(native, "rasterize_native", lambda *a, **k: False):
        want = render_depth(*args, with_faces=True, znear=0.15)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
