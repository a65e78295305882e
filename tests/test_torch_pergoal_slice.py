"""The slice's per-goal tiers (`PerceptionToPlan.pergoal`) at a tiny size,
float64 on the CPU: two objects of scene 36 at 48x48, the synthetic arm
with 10 points per link on a 10 cm grid, 4 goal slots, IK 5 iterations,
the exact tier at 2 iterations.

  - goal compaction: each object's kept-and-found slots first, in order;
  - the exact tier of object 0 against the JAX package's
    plan_pergoal_batch in points mode on the same goals, IK solutions and
    scene sets (Q 1e-8, cost 1e-8 relative). The JAX call stores goals as
    float32, so the port is given float32-rounded goals too;
  - the batch-first tiers equal one-object calls of each tier;
  - the clearance (K3 and a gathered normal) equals the minimum of K2's
    signed distances over the same points, resting contacts left out.
"""

import numpy as np
import pytest
import torch

from grasptrajopt_tpu.fields.scene_points import scene_point_sets_from_depth as jax_sets
from grasptrajopt_tpu.planning.gto_planner import GTOPlanner as JaxPlanner
from grasptrajopt_tpu_torch.e2e import PerceptionToPlan, SliceConfig, collect_observations
from grasptrajopt_tpu_torch.ops import nn
from grasptrajopt_tpu_torch.testing import make_synthetic_gripper
from torch_parity import make_jax_synth_robot, np_, port_robot

CFG = SliceConfig(
    batch=2, goal_capacity=4, width=48, height=48, scenes=(36,), ik_iterations=5,
    plan_iterations=3, coarse_iterations=2, final_trust=True, exact_iterations=2,
)


@pytest.fixture(scope="module")
def run():
    jr = make_jax_synth_robot(points_per_link=10, grid_resolution=0.1)
    obs = collect_observations(CFG)
    gripper = make_synthetic_gripper(device="cpu", dtype=torch.float64, points_per_link=10)
    path = PerceptionToPlan(port_robot(jr), gripper, CFG)
    out = path.run(obs)
    x = out["inputs"]
    x["tf_goal"] = x["tf_goal"].float().double()  # as the JAX call stores them
    return jr, obs, path, out, path.pergoal(obs, out)


def test_goal_compaction(run):
    _, _, _, out, pg = run
    mask = out["goal_mask"]
    assert torch.equal(pg["n_goals"], mask.sum(dim=1)) and bool((pg["n_goals"] >= 1).all())
    for b in range(CFG.batch):
        n = int(pg["n_goals"][b])
        assert torch.equal(pg["tf_goal"][b, :n], out["inputs"]["tf_goal"][b][mask[b]])
        assert torch.equal(pg["q_sols"][b, :n], out["q_sols"][b][mask[b]])


def test_exact_tier_matches_jax(run):
    jr, obs, path, out, pg = run
    n = int(pg["n_goals"][0])
    jp = JaxPlanner(
        jr, "hand", "hand", obstacle_mode="points", single_pass=True, standoff_distance=-0.1,
        iterations=CFG.exact_iterations, obstacle_weight=CFG.exact_obstacle_weight,
        sdf_epsilon=CFG.exact_epsilon, T=CFG.T,
    )
    so, st = jax_sets(
        obs.depth[0], obs.K, obs.cam_pose[0], obs.target_mask[0],
        capacity_obstacle=CFG.exact_points, capacity_target=CFG.exact_target_points,
        depth_threshold=CFG.depth_threshold, resolution=CFG.exact_resolution,
    )
    np.testing.assert_array_equal(np_(pg["sets"]["scene_points"][0]), so.points)
    np.testing.assert_array_equal(np_(pg["sets"]["target_normals"][0]), st.normals)
    Qj, cj = jp.plan_pergoal_batch(
        np_(path.qc), np_(pg["tf_goal"][0, :n]), None, None, obs.base_position,
        np_(pg["q_sols"][0, :n]).T, use_standoff=True, axis_standoff=CFG.axis_standoff,
        goal_capacity=CFG.goal_capacity, scene_obstacle=so, scene_target=st,
    )
    Q = np_(pg["Q_exact"][0, :n])
    assert np.isfinite(Q).all()
    np.testing.assert_allclose(Q, np.asarray(Qj).transpose(0, 2, 1), atol=1e-8, rtol=0)
    np.testing.assert_allclose(np_(pg["cost_exact"][0, :n]), np.asarray(cj), rtol=1e-8, atol=0)


def test_batched_tiers_equal_one_object_calls(run):
    _, _, path, out, pg = run
    b = 1
    sets = {k: v[b : b + 1] for k, v in pg["sets"].items()}
    args = (path.qc, pg["tf_goal"][b : b + 1], pg["n_goals"][b : b + 1], pg["q_sols"][b : b + 1],
            out["inputs"]["base_position"], True, CFG.axis_standoff)
    Qe, ce, _ = path.exact_planner.plan_pergoal_batch(*args, scene=sets)
    S2 = out["tables"].shape[0] // CFG.batch
    tables = out["tables"][b * S2 : (b + 1) * S2]
    Qr, cr, _ = path.planner.plan_pergoal_batch(*args, fields=(tables, out["field_base"][:1]))
    np.testing.assert_allclose(np_(pg["Q_exact"][b]), np_(Qe[0]), atol=1e-12, rtol=0)
    np.testing.assert_allclose(np_(pg["cost_exact"][b]), np_(ce[0]), rtol=1e-12, atol=0)
    np.testing.assert_allclose(np_(pg["Q_rescue"][b]), np_(Qr[0]), atol=1e-12, rtol=0)
    np.testing.assert_allclose(np_(pg["cost_rescue"][b]), np_(cr[0]), rtol=1e-12, atol=0)


def test_clearance_equals_k2_signed_distance(run):
    _, _, path, out, pg = run
    sets, base = pg["sets"], out["inputs"]["base_position"]
    before = nn.min_sqdist_launches
    got = path.clearance(pg["Q_rescue"], sets, base)
    assert nn.min_sqdist_launches == before  # CPU tensors take the plain K3
    pts = path.robot.fk_surface_points(pg["Q_rescue"], base)  # (C, G, T, P, 3)
    C = pts.shape[0]
    sd, _ = nn.signed_distance_with_dir(pts.reshape(C, -1, 3), sets["scene_points"], sets["scene_normals"])
    sd = sd.reshape(pts.shape[:-1])
    want = torch.where(sd[..., :1, :] < 0, torch.inf, sd).amin(dim=(-2, -1))
    assert torch.equal(got, want)
    assert torch.equal(pg["sd_rescue"], got)
