"""GraspPipeline.plan_object's tier logic in the port, with stub stages
and planners whose plans the test scores (each plan carries its id in
row 0), and one case against the JAX package:

  - the gate order: reward, then collision-free over reached, then
    reached, then the smaller position error;
  - the rescue only when the goal-set plan fails its gates;
  - the escalation in failure-mode order: the exact tier first when the
    best plan collides, the deep tier first on a clean miss, the second
    tier only when the first did not clear the trial;
  - the safe-decline truncation: tried only while the best plan collides,
    adopted only when it ranks higher; `_truncate_before_collision` holds
    a plan at its last step with at most 5 points inside;
  - JAX parity: the rescue branch forced as tests/test_pipeline.py does
    (a goal-set plan that never leaves the start), float64, T = 12, the
    per-goal field re-solve on the same fields and IK solutions: the
    rescued plan to 1e-6.
"""

import numpy as np
import pytest
import torch

from grasptrajopt_tpu.planning.gto_planner import GTOPlanner as JaxPlanner
from grasptrajopt_tpu.planning.pipeline import GraspPipeline as JaxPipeline
from grasptrajopt_tpu.testing import SYNTH_DEFAULT_POSE
from grasptrajopt_tpu_torch.planning import evaluate
from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner
from grasptrajopt_tpu_torch.planning.pipeline import GraspPipeline
from grasptrajopt_tpu_torch.testing import (
    SYNTH_EVAL_CONFIG,
    make_synthetic_gripper,
    make_synthetic_gto_robot,
)
from torch_parity import make_jax_synth_gripper, make_jax_synth_robot, observation, port_robot

QC = SYNTH_DEFAULT_POSE.astype(np.float64)
T = 12
N_GOALS = 3


def plan_of(i):
    plan = np.tile(QC[:, None], (1, T))
    plan[0] = i
    return plan


def score(reward=0, collision=False, reached=False, err_pos=0.05):
    return {"err_pos": err_pos, "err_rot": 1.0, "reached": reached, "collision": collision,
            "max_inside_points": 9 if collision else 0, "reward": reward}


OK = score(1, reached=True, err_pos=0.001)
MISS = score(err_pos=0.03)  # clean, unreached
HIT = score(collision=True, reached=True, err_pos=0.001)  # reached, colliding


@pytest.fixture(scope="module")
def robots():
    dt = torch.float64
    return (make_synthetic_gto_robot(device="cpu", dtype=dt, points_per_link=10, grid_resolution=0.1),
            make_synthetic_gripper(device="cpu", dtype=dt, points_per_link=10))


def stub_pipeline(robots, monkeypatch, scores, batches, trunc=None, escalate=True):
    """A pipeline whose stages are stubs: the goal-set plan is plan 0, the
    rescue / deep / exact tiers return the plans of batches['rescue'] /
    ['deep'] / ['exact'] (ids), each plan scores scores[id]; `trunc` is the
    truncation's plan id (None: no truncation). Returns (pipeline, the
    calls made in order)."""
    robot, gripper = robots
    p = GraspPipeline(robot, gripper, "hand", "hand", axis_standoff="z", goal_capacity=4, escalate=escalate)
    calls = []
    zeros = torch.zeros(robot.grid.size, dtype=torch.float32)
    monkeypatch.setattr(p, "build_fields", lambda *a: (None, "cloud", zeros, zeros))
    monkeypatch.setattr(p, "filter_grasps", lambda RT, pc: np.ones(len(RT), dtype=bool))
    monkeypatch.setattr(p, "screen_ik", lambda qc, RT, *a: (np.tile(QC, (len(RT), 1)), np.ones(len(RT), dtype=bool)))

    def plan_goalset(*a, **k):
        calls.append("plan")
        return plan_of(0), np.zeros((9, T - 1)), np.array([0.5])

    def tier(name):
        def run(*a, **k):
            calls.append(name)
            ids = batches[name]
            return np.stack([plan_of(i) for i in ids]), np.arange(len(ids), dtype=float)
        return run

    def truncate(plan, cloud, base):
        calls.append("truncate")
        return None if trunc is None else plan_of(trunc)

    monkeypatch.setattr(p.planner, "plan_goalset", plan_goalset)
    monkeypatch.setattr(p, "_plan_pergoal_field", tier("rescue"))
    monkeypatch.setattr(p, "_plan_pergoal_deep", tier("deep"))
    monkeypatch.setattr(p, "_plan_pergoal_exact", tier("exact"))
    monkeypatch.setattr(p, "_truncate_before_collision", truncate)
    monkeypatch.setattr(evaluate, "score_plan", lambda r, l, plan, *a, **k: dict(scores[int(plan[0, -1])]))
    monkeypatch.setattr(
        evaluate, "score_plans_pergoal", lambda r, l, plans, *a, **k: [dict(scores[int(q[0, -1])]) for q in plans]
    )
    return p, calls


def run(p):
    RT = np.tile(np.eye(4), (N_GOALS, 1, 1))
    return p.plan_object(QC, None, None, None, None, RT)


CASES = {
    # name: (scores, batches, trunc, escalate, calls, plan id, rescued, escalated)
    "plan passes": ({0: OK}, {}, None, True, ["plan"], 0, False, False),
    "rescue clears": ({0: MISS, 10: MISS, 11: OK}, {"rescue": [10, 11]}, None, True,
                      ["plan", "rescue"], 11, True, False),
    "exact first when colliding": ({0: HIT, 10: HIT, 20: OK}, {"rescue": [10], "exact": [20]}, None, True,
                                   ["plan", "rescue", "exact"], 20, True, True),
    "deep first on a clean miss": ({0: MISS, 10: score(err_pos=0.04), 30: OK}, {"rescue": [10], "deep": [30]},
                                   None, True, ["plan", "rescue", "deep"], 30, True, True),
    "second tier when needed": ({0: MISS, 10: score(err_pos=0.04), 30: score(err_pos=0.035), 20: OK},
                                {"rescue": [10], "deep": [30], "exact": [20]}, None, True,
                                ["plan", "rescue", "deep", "exact"], 20, True, True),
    "no tier improves": ({0: MISS, 10: score(err_pos=0.04), 30: score(err_pos=0.05), 20: HIT},
                         {"rescue": [10], "deep": [30], "exact": [20]}, None, True,
                         ["plan", "rescue", "deep", "exact"], 0, False, False),
    "gate order": ({0: score(collision=True), 10: HIT, 11: score(err_pos=0.05), 12: score(err_pos=0.03),
                    13: score(err_pos=0.04)},
                   {"rescue": [10, 11, 12, 13]}, None, False, ["plan", "rescue"], 12, True, False),
    "truncation adopted": ({0: HIT, 10: HIT, 40: MISS}, {"rescue": [10]}, 40, False,
                           ["plan", "rescue", "truncate"], 40, True, False),
    "truncation ranks lower": ({0: HIT, 10: score(collision=True, reached=True, err_pos=0.002), 41: score(
        collision=True, err_pos=0.2)}, {"rescue": [10]}, 41, False, ["plan", "rescue", "truncate"], 0, False, False),
    "no truncation": ({0: HIT, 10: HIT}, {"rescue": [10]}, None, False, ["plan", "rescue", "truncate"], 0, False,
                      False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tier_logic(robots, monkeypatch, case):
    scores, batches, trunc, escalate, want_calls, plan_id, rescued, escalated = CASES[case]
    p, calls = stub_pipeline(robots, monkeypatch, scores, batches, trunc, escalate)
    res = run(p)
    assert calls == want_calls
    assert res.stage == "ok" and int(res.plan[0, -1]) == plan_id
    assert (res.rescued, res.escalated) == (rescued, escalated)
    np.testing.assert_allclose(res.dQ, p.planner.dq_of(res.plan))


def test_truncate_before_collision(robots, monkeypatch):
    """Held at the last step before the first with more than 5 points
    inside; None when that is step 1 (step 0 is the start) or no step
    collides."""
    robot, gripper = robots
    p = GraspPipeline(robot, gripper, "hand", "hand")
    plan = np.tile(QC[:, None], (1, T))
    plan[0] = np.arange(T)
    for counts, held in (([0, 0, 0, 5, 2, 6, 9] + [0] * 5, 5), ([0, 0, 6] + [0] * 9, 2),
                         ([0, 6] + [0] * 10, None), ([0] * T, None)):
        monkeypatch.setattr(evaluate, "check_plan_collision",
                            lambda *a, c=counts, **k: (max(c) > 5, np.asarray(c)))
        out = p._truncate_before_collision(plan, None, (0.0, 0.0, 0.0))
        if held is None:
            assert out is None
        else:
            np.testing.assert_array_equal(out[0], list(range(held)) + [held - 1] * (T - held))


def test_forced_rescue_matches_jax():
    """The goal-set plan never leaves the start, so it misses every goal;
    the per-goal field rescue re-solves the 3 grasps in a capacity of 4 and
    the gate adopts the best, in both packages."""
    jr = make_jax_synth_robot(points_per_link=10, grid_resolution=0.1)
    pr = port_robot(jr)
    knobs = dict(axis_standoff="z", gripper_open_offsets=SYNTH_EVAL_CONFIG["gripper_open_offsets"],
                 goal_capacity=4, standoff_offset=-4, escalate=False)
    flavour = dict(iterations=3, single_pass=True, coarse_iterations=2, final_trust=True, standoff_offset=-4, T=T)
    jp = JaxPipeline(jr, make_jax_synth_gripper(10), "hand", "hand", grid=jr.grid, **knobs)
    pp = GraspPipeline(pr, make_synthetic_gripper(device="cpu", dtype=torch.float64, points_per_link=10),
                       "hand", "hand", grid=pr.grid, **knobs)
    jp.planner = JaxPlanner(jr, "hand", "hand", **flavour)
    pp.planner = GTOPlanner(pr, "hand", "hand", **flavour)
    obs = observation("tabletop", size=64)
    RT = obs["grasps_world"][:N_GOALS]
    RT_base = RT.copy()
    RT_base[:, :3, 3] -= obs["base_position"]
    q, _ = pp.screen_ik(QC, RT_base)
    found = np.ones(N_GOALS, dtype=bool)

    def bad_goalset(*a, **k):
        return np.tile(QC[:, None], (1, T)), np.zeros((9, T - 1)), np.array([1e6])

    for p in (jp, pp):
        p.screen_ik = lambda *a: (q, found)
        p.planner.plan_goalset = bad_goalset
    args = (QC, obs["depth"], obs["K"], obs["cam_pose"], obs["target_mask"], RT, obs["base_position"])
    got, want = pp.plan_object(*args), jp.plan_object(*args)
    assert got.rescued and want.rescued and not got.escalated
    np.testing.assert_allclose(got.plan, want.plan, atol=1e-6, rtol=0)
    assert abs(got.cost - want.cost) <= 1e-6 * (1 + abs(want.cost))
    np.testing.assert_allclose(got.dQ, pp.planner.dq_of(got.plan), atol=1e-12)
    assert not np.allclose(got.plan[:, -1], QC)
