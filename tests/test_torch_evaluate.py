"""The replay scorer of the port (planning/evaluate.py) against the JAX
package's on fixed plans: the synthetic arm (10 points per link, float64
in both) sweeping its shoulder forward into the tabletop of scene 10,
observed at 64x64 (the obstacle cloud: the nearest object masked out,
float32 in both), scored against that object's grasps.

Inside counts, collision and reach verdicts identical; errors to 1e-10.
Also the two error-attribution cases of tests/test_eval.py."""

import numpy as np
import pytest

from grasptrajopt_tpu.fields import depth_point_cloud as jdpc
from grasptrajopt_tpu.planning import evaluate as jev
from grasptrajopt_tpu.testing import SYNTH_DEFAULT_POSE
from grasptrajopt_tpu_torch.fields.depth_point_cloud import DepthPointCloud
from grasptrajopt_tpu_torch.planning import evaluate
from torch_parity import make_jax_synth_robot, observation, port_robot

T = 12


@pytest.fixture(scope="module")
def setup():
    jr = make_jax_synth_robot(points_per_link=10, grid_resolution=0.1)
    obs = observation("tabletop", size=64)
    d = np.array(obs["depth"], copy=True)
    d[obs["target_mask"]] = 1.5
    args = (d, obs["K"], obs["cam_pose"], obs["target_mask"])
    jc = jdpc.DepthPointCloud(*args, threshold=1.5)
    pc = DepthPointCloud(*args, threshold=1.5, device="cpu")
    RT = obs["grasps_world"][:4].copy()
    RT[:, :3, 3] -= obs["base_position"]
    # plans (n, ndof, T): the shoulder swung forward by 0.3-1.5 rad and the
    # elbow opened, the farther swings into the table
    s = np.linspace(0.0, 1.0, T)
    plans = np.tile(SYNTH_DEFAULT_POSE[None, :, None], (5, 1, T))
    plans[:, 1] += np.linspace(0.3, 1.5, 5)[:, None] * s
    plans[:, 3] += 0.6 * s
    return jr, port_robot(jr), jc, pc, RT, plans, obs["base_position"]


def test_check_plan_collision(setup):
    jr, pr, jc, pc, _, plans, base = setup
    verdicts = []
    for plan in plans:
        got = evaluate.check_plan_collision(pr, plan, pc, base)
        want = jev.check_plan_collision(jr, plan, jc, base)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        verdicts.append(got[0])
    assert any(verdicts) and not all(verdicts)  # both kinds occur
    # a threshold above every count clears every plan
    assert not evaluate.check_plan_collision(pr, plans[-1], pc, base, threshold_points=10_000)[0]


def test_goalset_reach_errors(setup):
    jr, pr, _, _, RT, plans, _ = setup
    for plan in plans:
        got = evaluate.goalset_reach_errors(pr, "hand", plan[:, -1], RT)
        want = jev.goalset_reach_errors(jr, "hand", plan[:, -1], RT)
        for g, w in zip(got, want):
            assert g.shape == (4,)
            np.testing.assert_allclose(g, w, atol=1e-10, rtol=0)


def _same_scores(got, want):
    assert got.keys() == want.keys()
    for k in ("reached", "collision", "max_inside_points", "reward"):
        assert got[k] == want[k], k
    for k in ("err_pos", "err_rot"):
        assert abs(got[k] - want[k]) <= 1e-10, k


def test_score_plans_pergoal_and_score_plan(setup):
    jr, pr, jc, pc, RT, plans, base = setup
    goals = np.concatenate([RT, RT[:1]])  # one goal per plan
    got = evaluate.score_plans_pergoal(pr, "hand", plans, goals, pc, base)
    want = jev.score_plans_pergoal(jr, "hand", plans, goals, jc, base)
    assert len(got) == len(want) == len(plans)
    for g, w in zip(got, want):
        _same_scores(g, w)
    # loose tolerances reach every goal: the reward is then the collision
    # verdict alone
    loose = evaluate.score_plans_pergoal(pr, "hand", plans, goals, pc, base, pos_tol=10.0, rot_tol_deg=360.0)
    assert [r["reward"] for r in loose] == [int(not r["collision"]) for r in got]
    for plan in plans:
        _same_scores(
            evaluate.score_plan(pr, "hand", plan, RT, pc, base),
            jev.score_plan(jr, "hand", plan, RT, jc, base),
        )


def test_errors_attributed_to_a_goal_meeting_tolerances(monkeypatch):
    """When reached, (err_pos, err_rot) come from a goal meeting BOTH
    tolerances, not the best combined score (goal 0 here, which fails the
    rotation tolerance)."""
    d, rot = np.array([0.001, 0.018]), np.array([12.0, 8.0])
    monkeypatch.setattr(evaluate, "goalset_reach_errors", lambda *a, **k: (d, rot))
    monkeypatch.setattr(evaluate, "check_plan_collision", lambda *a, **k: (False, np.zeros(5, dtype=int)))
    rec = evaluate.score_plan(None, "ee", np.zeros((7, 3)), None, None, pos_tol=0.02, rot_tol_deg=10.0)
    assert rec["reached"] and rec["reward"] == 1
    assert rec["err_pos"] == pytest.approx(0.018)
    assert rec["err_rot"] == pytest.approx(8.0)


def test_unreached_reports_best_combined(monkeypatch):
    d, rot = np.array([0.05, 0.2]), np.array([30.0, 2.0])
    monkeypatch.setattr(evaluate, "goalset_reach_errors", lambda *a, **k: (d, rot))
    monkeypatch.setattr(evaluate, "check_plan_collision", lambda *a, **k: (True, np.full(5, 9, dtype=int)))
    rec = evaluate.score_plan(None, "ee", np.zeros((7, 3)), None, None)
    assert not rec["reached"] and rec["collision"] and rec["reward"] == 0
    assert rec["err_pos"] == pytest.approx(0.05)
    assert rec["max_inside_points"] == 9
