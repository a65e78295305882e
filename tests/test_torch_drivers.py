"""The port's SceneReplica drivers (grasptrajopt_tpu_torch.{gto_planning,
evaluate_plans, ik_checking, gto_planning_mobile, save_videos,
visualize_robot, visualize_grasps, visualize_scenes, mesh_sdf_demo})
against the JAX package's examples, on the CPU:

  - SCENE_KNOBS equal examples/gto_planning.py's;
  - filter_grasps_by_collision: the same keep mask as the JAX driver's,
    ratios within 1/P, on synth7's gripper at its open offsets (100
    points a link) over a synthetic tabletop observation, for seeded
    standoff poses on both sides of the 1% line;
  - check_plan_collision: the same verdicts and per-step inside counts as
    examples/evaluate_plans.py's on plans clear of, grazing and inside the
    obstacles;
  - testing.make_scenereplica_tree at grasps_per_object=2 writes the files
    of tests/fake_dataset.make_mini_dataset byte for byte;
  - the planner builds a solver a grid (each object of a driver has its
    own grid);
  - gto_planning, evaluate_plans and ik_checking run over the tree on the
    port's fake PyBullet (float64, the kernels' plain versions; synth7 at
    10 points a link on a 10 cm grid, the env's window cut to 48x36, the
    planner at 2 two-pass iterations and the IK screen at 10, the
    simulator's waits skipped, 20 simulator steps a plan waypoint): the JAX
    result schema, at least 2 objects
    planned, the file read alike by both packages' aggregate_results;
  - mesh_sdf_demo and visualize_grasps give the JAX examples' artists, on
    an OBJ written here and on the tree; visualize_robot and
    visualize_scenes write their PNG;
  - every driver's --help with `jax` blocked, and the pybullet gate.

A `slow` test runs the JAX examples/gto_planning.py (`-r panda` over the
tree, its configs/panda.yaml naming synth7's URDFs) beside the port's
(`-r synth7`), both IK screens drawing the JAX restarts: keep masks, IK
found, plans within 1e-5.
"""

import importlib
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_parity  # noqa: F401  (one intra-op thread)
from grasptrajopt_tpu.fields.depth_point_cloud import DepthPointCloud as JaxDepthPointCloud
from grasptrajopt_tpu.utils.results import aggregate_results as jax_aggregate
from grasptrajopt_tpu_torch import evaluate_plans, gto_planning, ik_checking
from grasptrajopt_tpu_torch import testing as port_testing
from grasptrajopt_tpu_torch.envs import fake_pybullet as fp
from grasptrajopt_tpu_torch.fields.depth_point_cloud import DepthPointCloud
from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner
from grasptrajopt_tpu_torch.planning.ik_solver import IKSolver
from grasptrajopt_tpu_torch.testing import (
    SYNTH_DEFAULT_POSE,
    SYNTH_EVAL_CONFIG,
    SYNTH_SCENEREPLICA_CONFIG,
    make_scenereplica_tree,
    make_synthetic_gripper,
    make_synthetic_gto_robot,
)
from grasptrajopt_tpu_torch.utils import cli
from grasptrajopt_tpu_torch.utils.results import aggregate_results, load_results
from torch_parity import make_jax_synth_gripper, make_jax_synth_robot, observation, port_robot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVERS = ("gto_planning", "evaluate_plans", "ik_checking", "gto_planning_mobile", "save_videos",
           "visualize_robot", "visualize_grasps", "visualize_scenes", "mesh_sdf_demo")
WINDOW = (48, 36)
CPU_RUN = ["-r", "synth7", "-s", "10", "--device", "cpu"]


def jax_example(name):
    return importlib.import_module(f"examples.{name}")


@pytest.fixture(scope="module")
def port_sim():
    """The port's simulation layer bound to its own fake (reloaded), the
    previous `pybullet` module restored afterwards."""
    previous = sys.modules.get("pybullet")
    assert fp.install(force=True)
    for name in ("pybullet_api", "scene_replica"):
        importlib.reload(importlib.import_module(f"grasptrajopt_tpu_torch.envs.{name}"))
    yield importlib.import_module("grasptrajopt_tpu_torch.envs.scene_replica")
    fp.disconnect()
    if previous is None:
        sys.modules.pop("pybullet", None)
    else:
        sys.modules["pybullet"] = previous


@pytest.fixture(scope="module")
def tree(port_sim, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scenereplica") / "tree")
    make_scenereplica_tree(root, scene_id=10, grasps_per_object=2)
    return root


@pytest.fixture(scope="module")
def small_drivers(port_sim):
    """The drivers at test size: synth7 and its gripper at 10 points a
    link on a 10 cm grid, a 48x36 window, 2 two-pass planner iterations,
    10 IK iterations, no simulator waits, 20 simulator steps a plan
    waypoint."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        _small_drivers(port_sim, monkeypatch)
        yield


def _small_drivers(port_sim, monkeypatch):
    mk, mg = make_synthetic_gto_robot, make_synthetic_gripper
    monkeypatch.setattr(cli, "make_synthetic_gto_robot",
                        lambda *a, **k: mk(*a, **{**k, "points_per_link": 10, "grid_resolution": 0.1}))
    monkeypatch.setattr(cli, "make_synthetic_gripper",
                        lambda *a, **k: mg(*a, **{**k, "points_per_link": 10}))
    init = port_sim.SceneReplicaEnv.__init__
    monkeypatch.setattr(port_sim.SceneReplicaEnv, "__init__",
                        lambda self, *a, **k: init(self, *a, **{**k, "window_width": WINDOW[0],
                                                                "window_height": WINDOW[1]}))
    no_wait = types.SimpleNamespace(sleep=lambda s: None, time=time.time)
    monkeypatch.setattr(port_sim, "time", no_wait)
    monkeypatch.setattr(gto_planning, "time", no_wait)
    from grasptrajopt_tpu_torch.envs.pybullet_api import FixedBaseRobot

    execute = FixedBaseRobot.execute_plan
    monkeypatch.setattr(FixedBaseRobot, "execute_plan", lambda self, plan, num=None: execute(self, plan, 20))
    plan_init, ik_init = GTOPlanner.__init__, IKSolver.__init__
    monkeypatch.setattr(GTOPlanner, "__init__", lambda self, *a, **k: plan_init(self, *a, **{**k, "iterations": 2}))
    monkeypatch.setattr(IKSolver, "__init__", lambda self, *a, **k: ik_init(self, *a, **{**k, "iterations": 10}))


# -- data-free parity ----------------------------------------------------------

def test_scene_knobs_match_jax():
    assert gto_planning.SCENE_KNOBS == jax_example("gto_planning").SCENE_KNOBS


@pytest.fixture(scope="module")
def tabletop():
    """A synthetic tabletop observation (scene 10, its nearest object, 64
    px) and its obstacle clouds in both packages (the target masked to the
    depth threshold, as the planning driver masks it)."""
    obs = observation("tabletop", size=64)
    d = np.array(obs["depth"], copy=True)
    d[obs["target_mask"]] = 1.5
    args = (d, obs["K"], obs["cam_pose"], obs["target_mask"])
    return obs, DepthPointCloud(*args, threshold=1.5, device="cpu"), JaxDepthPointCloud(*args, threshold=1.5)


def test_filter_grasps_matches_jax(tabletop):
    obs, cloud, jax_cloud = tabletop
    rng = np.random.default_rng(0)
    # the object's grasps lowered by up to 15 cm and turned about world z:
    # the fingers reach into the table and the neighbouring objects
    RT = obs["grasps_world"][rng.integers(0, len(obs["grasps_world"]), 48)].copy()
    yaw = rng.uniform(-np.pi, np.pi, 48)
    Rz = np.zeros((48, 4, 4))
    Rz[:, 0, 0], Rz[:, 0, 1], Rz[:, 1, 0], Rz[:, 1, 1] = np.cos(yaw), -np.sin(yaw), np.sin(yaw), np.cos(yaw)
    Rz[:, 2, 2] = Rz[:, 3, 3] = 1.0
    RT[:, :3, :3] = Rz[:, :3, :3] @ RT[:, :3, :3]
    RT[:, 2, 3] -= rng.uniform(0.0, 0.15, 48)
    RT_offs = RT @ make_synthetic_gripper(device="cpu").get_standoff_pose(-0.01, "z")
    opened = SYNTH_EVAL_CONFIG["gripper_open_offsets"]
    gripper = make_synthetic_gripper(device="cpu", dtype=torch.float64, points_per_link=100)
    keep, ratios = gto_planning.filter_grasps_by_collision(gripper, opened, RT_offs, cloud)
    want_keep, want_ratios = jax_example("gto_planning").filter_grasps_by_collision(
        make_jax_synth_gripper(100), opened, RT_offs, jax_cloud
    )
    P = gripper.num_surface_points
    np.testing.assert_array_equal(keep, np.asarray(want_keep))
    np.testing.assert_allclose(ratios, np.asarray(want_ratios), rtol=0, atol=1.0 / P)
    assert keep.any() and not keep.all()  # both sides of the 1% line
    assert ((ratios > 0) & (ratios <= 0.01)).any() or (ratios > 0.01).sum() >= 5


def _inside_counts(robot, plan, cloud, base, port: bool):
    if port:
        Q = torch.as_tensor(plan.T)
        pts = robot.fk_surface_points(Q, base_position=torch.as_tensor(base))
        return (cloud.get_sdf(pts.reshape(-1, 3)) < 0).reshape(pts.shape[:2]).sum(dim=1).numpy()
    pts = robot.fk_surface_points(jnp.asarray(plan.T), base_position=jnp.asarray(base))
    return (np.asarray(cloud.get_sdf(np.asarray(pts).reshape(-1, 3))) < 0).reshape(pts.shape[:2]).sum(axis=1)


def test_check_plan_collision_matches_jax():
    obs = observation("tabletop", size=64)
    d = np.array(obs["depth"], copy=True)
    d[obs["target_mask"]] = 2.0  # the replay's mask
    args = (d, obs["K"], obs["cam_pose"], obs["target_mask"])
    cloud, jax_cloud = DepthPointCloud(*args, threshold=1.5, device="cpu"), JaxDepthPointCloud(*args, threshold=1.5)
    jr = make_jax_synth_robot(10)
    pr = port_robot(jr)
    base = obs["base_position"]
    jax_check = jax_example("evaluate_plans").check_plan_collision
    maxima = []
    # from the default pose the shoulder pitches forward (to its limit) and
    # the elbow unfolds: the arm sweeps from clear of the table into it
    for dip in np.linspace(0.0, 2.0, 11):
        goal = SYNTH_DEFAULT_POSE.copy()
        goal[1] += dip
        goal[3] += 0.6 * dip
        goal = np.clip(goal, pr.lower_actuated_joint_limits, pr.upper_actuated_joint_limits)
        plan = np.linspace(SYNTH_DEFAULT_POSE, goal, 12).T  # (ndof, T)
        counts = _inside_counts(pr, plan, cloud, base, port=True)
        np.testing.assert_array_equal(counts, _inside_counts(jr, plan, jax_cloud, base, port=False))
        got = evaluate_plans.check_plan_collision(pr, plan, cloud, base)
        assert got == jax_check(jr, plan, jax_cloud, base) == bool((counts > 5).any())
        maxima.append(int(counts.max()))
    assert min(maxima) == 0, maxima  # clear
    assert any(1 <= m <= 10 for m in maxima), maxima  # grazing
    assert max(maxima) > 10, maxima  # inside


def test_tree_matches_the_mini_dataset(port_sim, tmp_path, monkeypatch):
    """make_scenereplica_tree(grasps_per_object=2) writes every file of the
    JAX package's mini dataset byte for byte (the .mat headers' creation
    time pinned), and more: furniture, shelf metadata, synth7's URDFs."""
    from fake_dataset import make_mini_dataset

    monkeypatch.setattr(time, "asctime", lambda *a: "Thu Jan  1 00:00:00 1970")
    fresh = [k for k in ("grasptrajopt_tpu.envs.scene_replica", "grasptrajopt_tpu.envs.pybullet_api")
             if k not in sys.modules]
    try:
        jax_root, port_root = tmp_path / "jax", tmp_path / "port"
        names = make_mini_dataset(str(jax_root), scene_id=10)
    finally:
        for k in fresh:  # imported here under the port's fake: not kept
            sys.modules.pop(k, None)
    assert make_scenereplica_tree(str(port_root), scene_id=10, grasps_per_object=2) == names
    files = [p.relative_to(jax_root) for p in jax_root.rglob("*") if p.is_file()]
    assert len(files) == 16 * 3 + 1
    for rel in files:
        assert (port_root / rel).read_bytes() == (jax_root / rel).read_bytes(), rel
    for extra in ("objects/cafe_table/cafe_table.urdf", "objects/shelf/shelf.urdf",
                  "objects/floor/model_normalized.urdf", "shelf_scenes/metadata/meta-000010.mat",
                  "robots/synth7/synth7.urdf", "robots/synth7/synth7_gripper.urdf"):
        assert (port_root / extra).is_file(), extra


def test_scenereplica_grasp_sets():
    """32 grasps: 8 turns about the approach axis at 4 heights, all
    proper rotations; the fetch set turns about its approach axis x."""
    for fetch, axis in ((False, 2), (True, 0)):
        g = port_testing.scenereplica_grasps(32, fetch=fetch)
        assert g.shape == (32, 4, 4)
        np.testing.assert_allclose(g[:, :3, :3] @ g[:, :3, :3].transpose(0, 2, 1), np.tile(np.eye(3), (32, 1, 1)),
                                   atol=1e-12)
        np.testing.assert_allclose(np.linalg.det(g[:, :3, :3]), 1.0, atol=1e-12)
        approach = g[:, :3, axis]  # one approach direction for the whole set
        np.testing.assert_allclose(approach, np.tile(approach[:1], (32, 1)), atol=1e-12)
        assert len(np.unique(np.round(g[:, 2, 3], 6))) == 4
    np.testing.assert_array_equal(port_testing.scenereplica_grasps(2), np.stack([port_testing.top_down_grasp()] * 2))


def test_sim_urdf_fits_the_panda_wrapper(port_sim, tree):
    """synth7's simulator URDF under the Panda wrapper: 9 actuated joints
    (the arm's 7, the fingers at q[7:9]), the end-effector link 7 on the
    hand, the camera link 10 on the base; its planning model equals
    synth7's (the extra links carry no geometry)."""
    from grasptrajopt_tpu_torch.envs.pybullet_api import Panda
    from grasptrajopt_tpu_torch.planning.gto_models import GTORobotModel

    fp.resetSimulation()
    robot = Panda(os.path.join(tree, "robots", "synth7", "synth7.urdf"), (0.05, 0.0, 0.7))
    names = [fp.getJointInfo(robot._id, j)[12].decode() for j in range(fp.getNumJoints(robot._id))]
    assert robot.ndof == 9 and names[robot.ee_index] == "ee_link" and names[robot.camera_link_index] == "camera_link"
    assert [robot._actuated_joint_names[i] for i in robot.finger_index] == ["finger_joint_l", "finger_joint_r"]
    sim = GTORobotModel.from_urdf_string(
        port_testing.SYNTH_SIM_URDF, param_joints=port_testing.SYNTH_PARAM_JOINTS,
        collision_link_names=port_testing.SYNTH_COLLISION_LINKS, device="cpu", dtype=torch.float64)
    arm = make_synthetic_gto_robot("cpu", torch.float64)
    q = torch.as_tensor(SYNTH_DEFAULT_POSE)
    torch.testing.assert_close(sim.fk_surface_points(q), arm.fk_surface_points(q), rtol=0, atol=1e-12)
    fp.disconnect()


# -- the repair: a solver a grid -------------------------------------------------

def test_planner_builds_a_solver_for_each_grid():
    """GTOPlanner.setup_optimization keys its solvers by the grid (the JAX
    package's key): after the robot's grid changes, the planner plans on
    the new grid exactly as a fresh planner does."""
    from grasptrajopt_tpu_torch.fields.voxel_grid import VoxelGrid

    robot = make_synthetic_gto_robot("cpu", torch.float64, points_per_link=10, grid_resolution=0.1)
    first = robot.grid
    planner = GTOPlanner(robot, "hand", "hand", iterations=2)
    s_first = planner.setup_optimization(2, True, "z")
    pts = np.random.default_rng(0).uniform([0.2, -0.4, 0.3], [0.9, 0.4, 0.9], (200, 3))
    second = VoxelGrid.from_points(pts, resolution=0.07)
    assert second != first
    robot.grid = second
    s_second = planner.setup_optimization(2, True, "z")
    assert s_second is not s_first
    robot.grid = first
    assert planner.setup_optimization(2, True, "z") is s_first
    robot.grid = second

    field = np.random.default_rng(1).uniform(0.0, 0.05, second.size)
    goals = np.stack([port_testing.make_synthetic_goal(s) for s in (0, 1)])
    args = (SYNTH_DEFAULT_POSE, goals, field, field, np.array([0.0, 0.0, 0.0]))
    kw = dict(use_standoff=True, axis_standoff="z", goal_capacity=2)
    Q, _, cost = planner.plan_goalset(*args, **kw)
    Q_fresh, _, cost_fresh = GTOPlanner(robot, "hand", "hand", iterations=2).plan_goalset(*args, **kw)
    np.testing.assert_array_equal(Q, Q_fresh)
    np.testing.assert_array_equal(cost, cost_fresh)


# -- the drivers over the tree ------------------------------------------------------

@pytest.fixture(scope="module")
def planned(tree, small_drivers, tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("results"))
    return gto_planning.main(CPU_RUN + ["--assets_dir", tree, "--outdir", outdir, "--goal_capacity", "4"])


def test_drivers_run_over_the_tree(planned, tree, small_drivers, capsys):
    """gto_planning's result file in the JAX schema (test_drivers.py's
    checks) with both objects planned in both orderings, read alike by
    both packages' aggregate_results; evaluate_plans replays it and
    ik_checking screens the scene."""
    with open(planned) as f:
        results = json.load(f)
    assert set(results) == {"10"} and set(results["10"]) == {"nearest_first", "random"}
    planned_n = 0
    for objects in results["10"].values():
        assert set(objects) == {"009_gelatin_box", "010_potted_meat_can"}
        for rec in objects.values():
            assert {"reward", "plan", "checking_time", "ik_time", "planning_time"} <= set(rec)
            if rec["plan"] is not None:
                plan = np.asarray(rec["plan"])
                assert plan.shape == (9, 50) and np.isfinite(plan).all()
                planned_n += 1
    assert planned_n >= 2
    agg = aggregate_results(load_results(planned))
    assert agg == jax_aggregate(load_results(planned)) and agg["trials"] == 4

    got = evaluate_plans.main(CPU_RUN + ["--assets_dir", tree, "-f", planned])
    assert got["trials"] == 4 and got["total_collision"] == sum(got["collision_by_object"].values())
    screened = ik_checking.main(CPU_RUN + ["--assets_dir", tree])
    assert set(screened) == {"009_gelatin_box", "010_potted_meat_can"}
    assert all(f.shape == (2,) and f.dtype == bool for f, _ in screened.values())
    out = capsys.readouterr().out
    assert "grasps have IK" in out and "collision" in out


def test_evaluate_plans_without_pybullet_aggregates(planned, monkeypatch):
    """Where no `pybullet` module imports, the replay driver reports the
    recorded-success aggregation only, as the JAX driver does."""
    monkeypatch.setitem(sys.modules, "pybullet", None)
    got = evaluate_plans.main(["-f", planned])
    assert got == aggregate_results(load_results(planned))


# -- the viewers -------------------------------------------------------------------

def _artists(monkeypatch, visualizer_cls, run):
    """Run a viewer with its Visualizer's save captured; the artists."""
    from test_torch_viz import artists

    seen = []
    monkeypatch.setattr(visualizer_cls, "save", lambda self, path: seen.append(self))
    run()
    assert len(seen) == 1
    return artists(seen[0])


def _assert_close_artists(a, b, atol):
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert x[0] == y[0] and len(x[1]) == len(y[1])
        for u, v in zip(x[1], y[1]):
            np.testing.assert_allclose(u, v, rtol=0, atol=atol)
        for u, v in zip(x[2:], y[2:]):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_mesh_sdf_demo_matches_jax(tmp_path, monkeypatch):
    from grasptrajopt_tpu.viz import Visualizer as JaxVisualizer
    from grasptrajopt_tpu_torch.viz import Visualizer

    obj = tmp_path / "tetra.obj"
    obj.write_text("v 0 0 0\nv 0.1 0 0\nv 0 0.1 0\nv 0 0 0.1\nf 1 3 2\nf 1 2 4\nf 1 4 3\nf 2 3 4\n")
    png = str(tmp_path / "mesh_sdf.png")
    from grasptrajopt_tpu_torch import mesh_sdf_demo

    got = _artists(monkeypatch, Visualizer, lambda: mesh_sdf_demo.main(["-m", str(obj), "-o", png]))
    monkeypatch.setattr(sys, "argv", ["mesh_sdf_demo.py", "-m", str(obj), "-o", png])
    want = _artists(monkeypatch, JaxVisualizer, jax_example("mesh_sdf_demo").main)
    _assert_close_artists(got, want, atol=0.0)


def test_visualize_grasps_matches_jax(tree, tmp_path, monkeypatch):
    """The port's viewer with -r synth7 against the JAX example with -r
    panda over the same tree (its configs/panda.yaml names synth7's
    gripper URDF): the gripper ghosts' polygons agree to 1e-6 m (the JAX
    example's gripper model is float32, the port's on the CPU float64)."""
    from grasptrajopt_tpu.viz import Visualizer as JaxVisualizer
    from grasptrajopt_tpu_torch import visualize_grasps
    from grasptrajopt_tpu_torch.viz import Visualizer

    data = tmp_path / "data"
    (data / "configs").mkdir(parents=True)
    (data / "configs" / "panda.yaml").write_text(json.dumps({"robot_cfg": SYNTH_SCENEREPLICA_CONFIG}))
    for rel in ("robots/synth7/synth7_gripper.urdf",):
        (data / rel).parent.mkdir(parents=True, exist_ok=True)
        (data / rel).write_text(open(os.path.join(tree, rel)).read())
    png = str(tmp_path / "grasps.png")
    got = _artists(monkeypatch, Visualizer, lambda: visualize_grasps.main(
        ["-r", "synth7", "--assets_dir", tree, "-m", "009_gelatin_box", "--device", "cpu", "-o", png]))
    monkeypatch.setenv("GTO_DATA_DIR", str(data))
    monkeypatch.setattr(sys, "argv", ["visualize_grasps.py", "-r", "panda", "-d", tree, "-m", "009_gelatin_box",
                                      "-o", png])
    want = _artists(monkeypatch, JaxVisualizer, jax_example("visualize_grasps").main)
    _assert_close_artists(got, want, atol=1e-6)


@pytest.mark.parametrize("viewer, args", [
    ("visualize_robot", []),
    ("visualize_scenes", ["-n", "2", "-g", "1"]),
])
def test_viewers_write_their_png(viewer, args, tmp_path):
    png = tmp_path / f"{viewer}.png"
    importlib.import_module(f"grasptrajopt_tpu_torch.{viewer}").main(
        ["-r", "synth7", "--device", "cpu", "-o", str(png)] + args)
    assert png.stat().st_size > 1000


# -- entry points without JAX ----------------------------------------------------------

def test_help_and_the_pybullet_gate_without_jax():
    """Each driver's --help with `jax` and `pybullet` blocked (python -m
    ... --help runs the same parser), and the simulator drivers' gate:
    without pybullet they print the JAX drivers' message and exit 1."""
    code = (
        "import sys, io, contextlib, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pybullet'] = None\n"
        f"for name in {DRIVERS!r}:\n"
        "    mod = importlib.import_module('grasptrajopt_tpu_torch.' + name)\n"
        "    out = io.StringIO()\n"
        "    with contextlib.redirect_stdout(out):\n"
        "        try:\n"
        "            mod.make_args(['--help'])\n"
        "        except SystemExit as e:\n"
        "            assert e.code == 0, name\n"
        "    assert out.getvalue().startswith('usage:'), name\n"
        "    if name in ('gto_planning', 'ik_checking', 'gto_planning_mobile', 'save_videos'):\n"
        "        out = io.StringIO()\n"
        "        with contextlib.redirect_stdout(out):\n"
        "            try:\n"
        "                mod.main(['-f', 'x.json'] if name == 'save_videos' else [])\n"
        "            except SystemExit as e:\n"
        "                assert e.code == 1, name\n"
        "        assert 'needs pybullet' in out.getvalue(), name\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_no_cpu_fallback():
    """--device cuda without a card fails; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.resolve_device("cuda")


# -- the JAX driver beside the port's (slow) -----------------------------------------------

@pytest.mark.slow
def test_gto_planning_matches_the_jax_driver(tmp_path, monkeypatch):
    """examples/gto_planning.py (`-r panda` over the tree; its
    configs/panda.yaml names synth7's URDFs; float64 models, 10 IK
    iterations) against the port's (`-r synth7`, float64 on the CPU), both
    IK screens drawing the JAX restarts, both envs at 96x72, the planner
    at 10 two-pass iterations: the keep masks, the IK found masks, which
    objects are planned, and the plans within 1e-5."""
    import grasptrajopt_tpu.envs as jax_envs
    from grasptrajopt_tpu.envs import fake_pybullet as jax_fp
    from grasptrajopt_tpu.planning.gto_models import GTORobotModel as JaxModel
    from grasptrajopt_tpu.planning.gto_planner import GTOPlanner as JaxPlanner
    from grasptrajopt_tpu.planning.ik_solver import IKSolver as JaxIK
    from torch_parity import use_jax_restarts

    window = dict(window_width=96, window_height=72)
    jr = make_jax_synth_robot(10)
    record = {"port": {"keep": [], "found": [], "plans": []}, "jax": {"keep": [], "found": [], "plans": []}}

    def recording(which, module):
        orig = module.filter_grasps_by_collision

        def run(*a, **k):
            keep, ratios = orig(*a, **k)
            record[which]["keep"].append(np.asarray(keep))
            return keep, ratios
        monkeypatch.setattr(module, "filter_grasps_by_collision", run)

    def run_driver(which, module, argv, sim, fake, scene_replica):
        previous = sys.modules.get("pybullet")
        assert fake.install(force=True)
        for name in ("pybullet_api", "scene_replica"):
            importlib.reload(importlib.import_module(f"{sim}.envs.{name}"))
        init = scene_replica.SceneReplicaEnv.__init__
        monkeypatch.setattr(scene_replica.SceneReplicaEnv, "__init__",
                            lambda self, *a, **k: init(self, *a, **{**k, **window}))
        monkeypatch.setattr(scene_replica, "time", types.SimpleNamespace(sleep=lambda s: None, time=time.time))
        monkeypatch.setattr(module, "time", types.SimpleNamespace(sleep=lambda s: None, time=time.time))
        try:
            return module.main(argv) if which == "port" else module.main()
        finally:
            fake.disconnect()
            sys.modules["pybullet"] = previous

    tree = str(tmp_path / "tree")
    fp.install(force=True)
    make_scenereplica_tree(tree, 10, grasps_per_object=8)
    os.makedirs(os.path.join(tree, "configs"))
    with open(os.path.join(tree, "configs", "panda.yaml"), "w") as f:
        json.dump({"robot_cfg": SYNTH_SCENEREPLICA_CONFIG}, f)

    # both IK screens: 10 iterations, the JAX restarts; both planners: 10
    # two-pass iterations; the JAX models in float64, as the port's
    for cls in (JaxIK, IKSolver):
        init = cls.__init__
        monkeypatch.setattr(cls, "__init__", lambda self, *a, _i=init, **k: (_i(self, *a, **k),
                                                                            setattr(self, "iterations", 10))[0])
    port_ik_init = IKSolver.__init__
    monkeypatch.setattr(IKSolver, "__init__", lambda self, *a, **k: (port_ik_init(self, *a, **k),
                                                                     use_jax_restarts(self, jr))[0])
    for cls in (JaxPlanner, GTOPlanner):
        init = cls.__init__
        monkeypatch.setattr(cls, "__init__", lambda self, *a, _i=init, **k: _i(self, *a, **{**k, "iterations": 10}))
    jax_model_init = JaxModel.__init__
    monkeypatch.setattr(JaxModel, "__init__", lambda self, *a, **k: jax_model_init(self, *a, **{**k, "dtype": jnp.float64}))

    for which, cls in (("port", IKSolver), ("jax", JaxIK)):
        solve = cls.solve_ik_batch

        def run_ik(self, *a, _s=solve, _w=which, **k):
            out = _s(self, *a, **k)
            e, r = np.asarray(out[1]), np.asarray(out[2])
            record[_w]["found"].append((e < 0.01) & (r < 5))
            return out
        monkeypatch.setattr(cls, "solve_ik_batch", run_ik)
    for which, cls in (("port", GTOPlanner), ("jax", JaxPlanner)):
        plan = cls.plan_goalset

        def run_plan(self, *a, _p=plan, _w=which, **k):
            out = _p(self, *a, **k)
            record[_w]["plans"].append(np.asarray(out[0]))
            return out
        monkeypatch.setattr(cls, "plan_goalset", run_plan)

    jax_gto = jax_example("gto_planning")
    recording("port", gto_planning)
    recording("jax", jax_gto)
    port_scene = importlib.import_module("grasptrajopt_tpu_torch.envs.scene_replica")
    run_driver("port", gto_planning, CPU_RUN + ["--assets_dir", tree, "--outdir", str(tmp_path / "port"),
                                                "--goal_capacity", "8"],
               "grasptrajopt_tpu_torch", fp, port_scene)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["gto_planning.py", "-r", "panda", "-s", "10", "--assets_dir", tree,
                                      "--goal_capacity", "8"])
    importlib.reload(jax_envs)
    jax_scene = importlib.import_module("grasptrajopt_tpu.envs.scene_replica")
    monkeypatch.setattr(jax_gto, "HAS_PYBULLET", True)
    run_driver("jax", jax_gto, None, "grasptrajopt_tpu", jax_fp, jax_scene)

    got, want = record["port"], record["jax"]
    assert len(got["keep"]) == len(want["keep"]) == 4
    for a, b in zip(got["keep"], want["keep"]):
        np.testing.assert_array_equal(a, b)
    assert len(got["found"]) == len(want["found"])
    for a, b in zip(got["found"], want["found"]):
        np.testing.assert_array_equal(a, b)
    assert len(got["plans"]) == len(want["plans"]) >= 2
    for a, b in zip(got["plans"], want["plans"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    print(f"keep {[int(k.sum()) for k in got['keep']]}, found {[int(f.sum()) for f in got['found']]}, "
          f"plans {len(got['plans'])}")
