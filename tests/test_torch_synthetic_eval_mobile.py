"""The port's mobile harness (grasptrajopt_tpu_torch.synthetic_eval_mobile)
against the JAX package's (examples/synthetic_eval_mobile.py) on tabletop
scene 10 (3 objects, nearest first) at 48x48: the synthetic arm and its
gripper (10 points per link, float64, the workspace grid at 10 cm), the
base parked at (-0.8, 0.3, yaw -0.3) on synth7's 0.7 m mount.

Base placement: both packages' `plan_base_placement` with the same start
pose and the same numpy seed draw the same grasp subsets, take the same
number of tries with the same col_cost sequence, and place the base
within 1e-6 (RT_base_new). Then the objects' trials in order in the new
base frame through both pipelines (goal capacity 12, the bench's planner
flavour: 3 iterations, single pass, coarse 2+1, final_trust), both IK
screens drawing the JAX package's restarts at 10 LM iterations
(tests/test_torch_synthetic_eval.py says why): the new-frame inputs
(camera pose and grasps) within 1e-12, identical stage, reward, grasp
counts, flags and scorer verdicts, errors and plans within 1e-5. At the
placement for all three objects the first object's IK screen finds no
solution (synth7 from the zero start pose the example uses: the base
solve's goals are off by 2-43 cm and 80-155 degrees); the second object
plans, with the rescue and an escalation tier. Its trial costs the JAX
package's plan, rescue and tier compiles (the file takes about 230 s
instead of 50), so it is marked `slow`.

The example imports `synthetic_eval` as a top-level module, so the
fixture puts examples/ on sys.path (nothing in examples/ changes)."""

import os

import numpy as np
import pytest
import torch

from grasptrajopt_tpu.planning.base_planner import BasePlanner as JaxBasePlanner
from grasptrajopt_tpu.planning.ik_solver import IKSolver as JaxIK
from grasptrajopt_tpu_torch import synthetic_eval_mobile as mobile
from grasptrajopt_tpu_torch.planning.base_planner import BasePlanner
from grasptrajopt_tpu_torch.planning.ik_solver import IKSolver
from grasptrajopt_tpu_torch.testing import SYNTH_EVAL_CONFIG, make_synthetic_gripper
from torch_parity import make_jax_synth_gripper, make_jax_synth_robot, port_robot, use_jax_restarts

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
IK_ITERATIONS = 10
SCENE, SIZE, CAPACITY = 10, 48, 12
FLAVOUR = dict(goal_capacity=CAPACITY, iterations=3, single_pass=True, coarse_iterations=2, final_trust=True)


def recording(planner):
    """Wrap a BasePlanner instance's plan_goalset to record each try's
    col_cost."""
    costs, solve = [], planner.plan_goalset

    def run(*args, **kwargs):
        out = solve(*args, **kwargs)
        costs.append(out[4])
        return out

    planner.plan_goalset = run
    return costs


@pytest.fixture(scope="module")
def runs():
    """Both placements; the trials run on demand (`trial`), in order, with
    the IK patches held for the module."""
    mp = pytest.MonkeyPatch()
    mp.syspath_prepend(EXAMPLES)
    try:
        import synthetic_eval_mobile as jax_mobile  # examples/synthetic_eval_mobile.py
        from grasptrajopt_tpu.envs.synthetic import SyntheticSceneEnv as JaxEnv
        from grasptrajopt_tpu.planning.pipeline import GraspPipeline as JaxPipeline
        from grasptrajopt_tpu_torch.envs.synthetic import SyntheticSceneEnv

        jr = make_jax_synth_robot(points_per_link=10, grid_resolution=0.1)
        pr = port_robot(jr)
        cfg = dict(SYNTH_EVAL_CONFIG)
        out = {"jax_mobile": jax_mobile, "jr": jr, "pr": pr, "cfg": cfg}
        for tag, Env, mod, robot, Planner in (("jax", JaxEnv, jax_mobile, jr, JaxBasePlanner),
                                              ("port", SyntheticSceneEnv, mobile, pr, BasePlanner)):
            env = Env(robot_name=cfg["robot_name"], scene_type="tabletop", n_objects=3, width=SIZE, height=SIZE)
            meta = env.setup_scene(SCENE)
            env.reset_scene()
            order = meta["nearest_first"].split(",")
            RT_base = mobile.base_pose_matrix(-0.8, 0.3, -0.3)
            RT_base[2, 3] = env.base_position[2]  # synth7's mount
            planner = Planner(robot, cfg["link_ee"], cfg["link_gripper"])
            costs = recording(planner)
            placed = mod.plan_base_placement(env, robot, planner, RT_base, meta, order,
                                             np.random.default_rng(SCENE))
            out[tag] = {"env": env, "order": order, "RT_base_new": placed[0], "y": placed[1],
                        "costs": costs, "placed": placed, "trials": [], "inputs": []}

        for cls in (JaxIK, IKSolver):
            init = cls.__init__

            def fewer_iterations(self, *a, _init=init, **k):
                _init(self, *a, **k)
                self.iterations = IK_ITERATIONS
            mp.setattr(cls, "__init__", fewer_iterations)
        port_init = IKSolver.__init__

        def with_jax_restarts(self, *a, **k):
            port_init(self, *a, **k)
            use_jax_restarts(self, jr)
        mp.setattr(IKSolver, "__init__", with_jax_restarts)
        out["port"]["pipeline"] = mobile.make_pipeline(
            pr, make_synthetic_gripper(device="cpu", dtype=torch.float64, points_per_link=10), cfg, "tabletop",
            **FLAVOUR,
        )
        knobs = jax_mobile.SCENE_KNOBS["tabletop"]
        out["jax"]["pipeline"] = JaxPipeline(
            jr, make_jax_synth_gripper(10), cfg["link_ee"], cfg["link_gripper"],
            axis_standoff=cfg["axis_standoff"], gripper_open_offsets=cfg["gripper_open_offsets"],
            standoff_distance=knobs["standoff_distance"], goal_capacity=CAPACITY, grid=jr.grid,
            ik_capacity=CAPACITY, planner_iterations=FLAVOUR["iterations"], planner_single_pass=True,
            planner_coarse_iterations=FLAVOUR["coarse_iterations"], planner_coarse_stride=2,
            planner_final_trust=True, goal_weight=1.0, interpolate=knobs.get("interpolate", True),
        )
        yield out
    finally:
        mp.undo()


def jax_trial(runs, name, RT_base_new):
    """The JAX example's per-object loop body: (record, (cam_pose_b, RTs_b))."""
    from grasptrajopt_tpu.fields import DepthPointCloud as JaxCloud
    from grasptrajopt_tpu.planning.evaluate import score_plan as jax_score_plan

    env, pipeline, cfg = runs["jax"]["env"], runs["jax"]["pipeline"], runs["cfg"]
    RT_base_inv = np.linalg.inv(RT_base_new)
    cam_pose_w = runs["jax_mobile"].head_camera_pose(RT_base_new, env._placed(name).pose[:3, 3])
    depth, mask, _, K = env.get_observation(cam_pose_w)
    cam_pose_b = RT_base_inv @ cam_pose_w
    target_mask = mask == env._placed(name).uid
    RTs_b = RT_base_inv[None] @ env.grasps_world(name, capacity=CAPACITY)
    res = pipeline.plan_object(np.asarray(cfg["default_pose"]), depth, K, cam_pose_b, target_mask, RTs_b,
                               np.zeros(3))
    rec = {"reward": 0, "stage": res.stage, "num_grasps": res.n_grasps, "num_collision_free": res.n_collision_free,
           "num_ik": res.n_ik_found, "rescued": res.rescued, "escalated": res.escalated}
    if res.plan is not None:
        depth_obs = np.array(depth, copy=True)
        depth_obs[target_mask] = pipeline.depth_threshold
        dpc = JaxCloud(depth_obs, K, cam_pose_b, target_mask, threshold=pipeline.depth_threshold)
        rec.update(jax_score_plan(runs["jr"], cfg["link_ee"], res.plan, RTs_b, dpc, np.zeros(3)))
        rec["plan"] = res.plan.tolist()
    return rec, (cam_pose_b, RTs_b)


def trial(runs, index):
    """The index-th object's trial in both packages at the JAX placement
    (earlier objects run first and are removed, as the harness does)."""
    RT_base_new = runs["jax"]["RT_base_new"]
    RT_base_inv = np.linalg.inv(RT_base_new)
    port, jax_run = runs["port"], runs["jax"]
    while len(port["trials"]) <= index:
        name = jax_run["order"][len(port["trials"])]
        env = port["env"]
        cam_w = mobile.head_camera_pose(RT_base_new, env._placed(name).pose[:3, 3])
        port["inputs"].append((RT_base_inv @ cam_w, RT_base_inv[None] @ env.grasps_world(name, capacity=CAPACITY)))
        port["trials"].append(mobile.run_object(env, runs["pr"], port["pipeline"], runs["cfg"], name, RT_base_new,
                                                CAPACITY))
        env.remove_object(name)
        rec, inputs = jax_trial(runs, name, RT_base_new)
        jax_run["trials"].append(rec)
        jax_run["inputs"].append(inputs)
        jax_run["env"].remove_object(name)
    return port["trials"][index], jax_run["trials"][index], port["inputs"][index], jax_run["inputs"][index]


def test_base_placement_matches_jax(runs):
    jax_run, port_run = runs["jax"], runs["port"]
    assert port_run["order"] == jax_run["order"] and len(port_run["order"]) == 3
    assert port_run["costs"] == jax_run["costs"] and port_run["costs"][-1] == 0.0
    tries = port_run["placed"][2]
    assert [t["col_cost"] for t in tries] == port_run["costs"]
    np.testing.assert_allclose(port_run["RT_base_new"], jax_run["RT_base_new"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(port_run["y"], jax_run["y"], atol=1e-6, rtol=0)
    assert -np.pi <= port_run["y"][2] <= np.pi
    # the base stays on synth7's mount and only turns about z
    assert port_run["RT_base_new"][2, 3] == pytest.approx(0.7, abs=1e-12)
    np.testing.assert_allclose(port_run["RT_base_new"][2, :3], [0.0, 0.0, 1.0], atol=1e-12)


@pytest.mark.parametrize("index,stage", [(0, "no_ik"), pytest.param(1, "ok", marks=pytest.mark.slow)])
def test_trial_in_the_new_frame_matches_jax(runs, index, stage):
    a, b, (cam_p, RTs_p), (cam_j, RTs_j) = trial(runs, index)
    np.testing.assert_allclose(cam_p, cam_j, atol=1e-12, rtol=0)
    np.testing.assert_allclose(RTs_p, RTs_j, atol=1e-12, rtol=0)
    for k in ("reward", "stage", "num_grasps", "num_collision_free", "num_ik", "rescued", "escalated",
              "reached", "collision", "max_inside_points"):
        assert a.get(k) == b.get(k), k
    assert a["stage"] == stage
    assert ("plan" in a) == ("plan" in b)
    if "plan" in a:
        for k in ("err_pos", "err_rot"):
            assert abs(a[k] - b[k]) <= 1e-5, k
        np.testing.assert_allclose(np.asarray(a["plan"]), np.asarray(b["plan"]), atol=1e-5, rtol=0)
