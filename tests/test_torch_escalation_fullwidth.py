"""Both escalation tiers of GraspPipeline at full width in both packages
on the CPU: the observation of the closed-loop smoke run's last shelf
trial (shelf scene 10, random order, the third object, the first two
removed; two views at 160x160), the synthetic arm at 100 points per link
on the shelf's 2.5 cm grid with its gripper (300 points), the harness's
shelf knobs (standoff -0.2 m, goal weight 4, planning fields from the
first view over a 1 cm dedup, goal capacity 32) and the bench's planner
flavour. Both packages get the same tier inputs: the goals and IK
solutions of the port's screen, and the JAX package's cost fields (the
field builds agree to 1e-6, tests/test_torch_pipeline_stages.py); each
scores its plans with its own replay scorer against its own fused cloud.

  - exact tier (points mode, obstacle weight 40): the port's batch of 32
    problems; the JAX package's goals one problem at a time (its CPU
    distance pass is a dense (queries x points) matrix, 26 GB for the
    batch), each the same single-goal problem as its slot of the batch;
  - deep tier (the field re-solve at 12 iterations, goal weight x 4): both
    packages' own tier method.

In float32 (the card's type) the collision verdicts must be identical;
the plans are reported, not held: 12 LM iterations in float32 amplify the
two packages' different distance arithmetic (the JAX CPU pass expands
|q|^2 + |r|^2 - 2 q.r) into different accept decisions. In float64 the
plans must also agree to 1e-6 rad. Marked slow (about an hour): run it
with `python -m pytest -m slow -s tests/test_torch_escalation_fullwidth.py`;
it prints the counts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grasptrajopt_tpu.planning import evaluate as jax_evaluate
from grasptrajopt_tpu.planning.gto_models import GTORobotModel as JaxRobot
from grasptrajopt_tpu.planning.pipeline import GraspPipeline as JaxPipeline
from grasptrajopt_tpu.testing import SYNTH_ARM_URDF, SYNTH_COLLISION_LINKS, SYNTH_DEFAULT_POSE, SYNTH_PARAM_JOINTS
from grasptrajopt_tpu_torch.envs.synthetic import SyntheticSceneEnv
from grasptrajopt_tpu_torch.planning import evaluate as port_evaluate
from grasptrajopt_tpu_torch.planning.pipeline import GraspPipeline
from grasptrajopt_tpu_torch.testing import SYNTH_EVAL_CONFIG, SYNTH_GRIPPER_URDF, make_synthetic_gripper
from torch_parity import jax_robot_state
from grasptrajopt_tpu_torch.convert import robot_from_numpy

pytestmark = pytest.mark.slow
CAP = 32
KNOBS = dict(
    axis_standoff=SYNTH_EVAL_CONFIG["axis_standoff"], gripper_open_offsets=SYNTH_EVAL_CONFIG["gripper_open_offsets"],
    standoff_distance=-0.2, goal_capacity=CAP, ik_capacity=CAP, planner_iterations=3, planner_single_pass=True,
    planner_coarse_iterations=2, planner_final_trust=True, goal_weight=4.0, interpolate=False,
    field_epsilon=0.02, field_downsample=0.01, plan_views=1,
)


def shelf_observation(index=2, size=160):
    """Shelf scene 10 in the random order with its first `index` objects
    removed: two views of object `index` (lists), K, its 32 world grasps
    and the robot base."""
    env = SyntheticSceneEnv(robot_name="panda", scene_type="shelf", n_objects=3, width=size, height=size)
    meta = env.setup_scene(10)
    env.reset_scene()
    names = meta["random"].split(",")
    for name in names[:index]:
        env.remove_object(name)
    name = names[index]
    uid = env._placed(name).uid
    depths, masks, poses = [], [], []
    for cp in env.camera_poses(2):
        d, ids, _, K = env.get_observation(cp)
        depths.append(d)
        masks.append(ids == uid)
        poses.append(cp)
    return name, depths, K, poses, masks, env.grasps_world(name, capacity=CAP), np.asarray(env.base_position)


@pytest.fixture(scope="module", params=["float32", "float64"])
def tiers(request):
    jdt, pdt = (jnp.float32, torch.float32) if request.param == "float32" else (jnp.float64, torch.float64)
    qc = SYNTH_DEFAULT_POSE.astype(request.param)
    jr = JaxRobot(model_dir="", urdf_string=SYNTH_ARM_URDF, time_derivs=[0, 1], param_joints=SYNTH_PARAM_JOINTS,
                  collision_link_names=SYNTH_COLLISION_LINKS, points_per_link=100, grid_resolution=0.025,
                  dtype=jdt)
    jr.setup_workspace_field(arm_len=1.1, arm_height=0.2)
    pr = robot_from_numpy(jax_robot_state(jr), device="cpu", dtype=pdt)
    jg = JaxRobot(model_dir="", urdf_string=SYNTH_GRIPPER_URDF, points_per_link=100, dtype=jdt)
    pg = make_synthetic_gripper(device="cpu", dtype=pdt, points_per_link=100)
    jp = JaxPipeline(jr, jg, "hand", "hand", grid=jr.grid, **KNOBS)
    pp = GraspPipeline(pr, pg, "hand", "hand", grid=pr.grid, **KNOBS)
    name, depths, K, poses, masks, RTs, base = shelf_observation()
    views = (depths, K, poses, masks)
    _, jax_cloud, sdf_all, sdf_obs = jp.build_fields(*views)
    sdf_all, sdf_obs = np.asarray(sdf_all), np.asarray(sdf_obs)
    _, port_cloud, _, _ = pp.build_fields(*views)
    keep = pp.filter_grasps(RTs, pp._plan_pc_obstacle)
    RT_base = RTs[keep].copy()
    RT_base[:, :3, 3] -= base
    q, found = pp.screen_ik(qc, RT_base, sdf_obs, base)
    RT_base, q_solutions = RT_base[found], q[found].T
    n = RT_base.shape[0]
    out = {"name": name, "n": n, "kept": int(keep.sum()), "dtype": request.param}
    for pkg, p, cloud, scorer in (("port", pp, port_cloud, port_evaluate), ("jax", jp, jax_cloud, jax_evaluate)):
        Q_deep, _ = p._plan_pergoal_deep(qc, RT_base, sdf_all, sdf_obs, base, q_solutions, CAP)
        if pkg == "port":
            Q_exact, _ = p._plan_pergoal_exact(qc, RT_base, base, q_solutions, CAP, *views)
        else:  # one problem at a time: the same single-goal problems as the batch's slots
            Q_exact = np.concatenate([
                np.asarray(p._plan_pergoal_exact(qc, RT_base[i : i + 1], base, q_solutions[:, i : i + 1], 1, *views)[0])
                for i in range(n)
            ])
        for tier, Q in (("exact", np.asarray(Q_exact)), ("deep", np.asarray(Q_deep))):
            scores = scorer.score_plans_pergoal(p.robot, "hand", Q, RT_base, cloud, base,
                                                pos_tol=p.rescue_pos_tol, rot_tol_deg=p.rescue_rot_tol_deg)
            out[(pkg, tier)] = (Q, [bool(s["collision"]) for s in scores], [int(s["max_inside_points"]) for s in scores],
                                [bool(s["reached"]) for s in scores])
    return out


@pytest.mark.parametrize("tier", ["exact", "deep"])
def test_tier_verdicts_match_jax(tiers, tier):
    port, jax_ = tiers[("port", tier)], tiers[("jax", tier)]
    n = tiers["n"]
    diff = np.abs(port[0] - jax_[0]).max()
    print(f"\n{tiers['dtype']} {tier} tier on shelf scene 10's {tiers['name']} ({tiers['kept']} kept grasps, {n} found "
          f"by IK): port {sum(port[1])} of {n} plans collide, {sum(port[3])} reach; JAX {sum(jax_[1])} of {n} collide, "
          f"{sum(jax_[3])} reach; max inside points port {port[2]}, JAX {jax_[2]}; max |plan difference| {diff:.3e} rad")
    assert n > 0
    assert port[1] == jax_[1]
    if tiers["dtype"] == "float64":
        np.testing.assert_allclose(port[0], jax_[0], atol=1e-6, rtol=0)
