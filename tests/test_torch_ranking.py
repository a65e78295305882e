"""The warm-start ranking and the single-problem planning API against the
JAX package, float64 (the synthetic arm, 10 points per link, T = 12, the
first object of scene 36 with its grasps and scene point sets):

  - `rank_seed_scores` in field mode with and without the rank strides,
    and in points mode (the shaped signed distance, K2's plain version);
    costs and travel to 1e-12;
  - `rank_pick`'s lexicographic (cost, travel) rule on ties;
  - `plan_goalset` in field mode (ranked, interpolated warm start,
    goal coherence on the goal-aligned candidates) and in points mode
    (a padded goal set and the held warm start, interpolate=False): Q to
    1e-8, cost to 1e-9 relative; `plan` is `plan_goalset` with a zero
    scene field.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from grasptrajopt_tpu.planning.gto_planner import GTOPlanner as JaxPlanner
from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner
from pergoal_parity import QC, jax_sets_of, problem
from torch_parity import make_jax_synth_robot, np_, port_robot, t64

T = 12


@pytest.fixture(scope="module")
def setup():
    jr = make_jax_synth_robot(points_per_link=10)
    obs, tf_goal, q_sols, sets = problem()
    field = np.random.default_rng(3).uniform(0.0, 0.1, size=jr.grid.size)
    return jr, port_robot(jr), obs, tf_goal, q_sols, sets, field


@pytest.mark.parametrize("strides", [(1, 1), (2, 2), (3, 1)])
def test_rank_seed_scores_field_matches_jax(setup, strides):
    jr, pr, obs, _, q_sols, _, field = setup
    kw = dict(T=T, rank_t_stride=strides[0], rank_p_stride=strides[1])
    jp, pp = JaxPlanner(jr, "hand", "hand", **kw), GTOPlanner(pr, "hand", "hand", **kw)
    seeds = np.asarray(jp._seed_trajectories(jnp.asarray(QC), jnp.asarray(q_sols[0].T)))
    np.testing.assert_allclose(np_(pp._seed_trajectories(t64(QC), t64(q_sols[0]))), seeds, atol=1e-15, rtol=0)
    want = jp.rank_seed_scores(seeds, field, obs.base_position)
    got = pp.rank_seed_scores(t64(seeds), t64(field), t64(obs.base_position))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_(g), np.asarray(w), atol=1e-12, rtol=0)
    assert np.ptp(np_(got[0])) > 0  # the seeds' costs differ
    assert int(pp.rank_pick(*got)) == int(jp.rank_pick(*want))


def test_rank_seed_scores_points_matches_jax(setup):
    jr, pr, obs, _, q_sols, sets, _ = setup
    kw = dict(T=T, obstacle_mode="points", sdf_epsilon=0.03)
    jp, pp = JaxPlanner(jr, "hand", "hand", **kw), GTOPlanner(pr, "hand", "hand", **kw)
    seeds = np.asarray(jp._seed_trajectories(jnp.asarray(QC), jnp.asarray(q_sols[0].T)))
    want = jp.rank_seed_scores(seeds, None, obs.base_position, scene_obstacle=jax_sets_of(obs, 0)[0])
    got = pp.rank_seed_scores(t64(seeds), None, t64(obs.base_position), scene_obstacle=sets[0][0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_(g), np.asarray(w), atol=1e-12, rtol=0)


@pytest.mark.parametrize(
    "costs,dists,want",
    [
        ([1.0, 0.0, 0.0, 2.0], [5.0, 3.0, 1.0, 0.0], 2),  # least cost, then least travel
        ([0.5, 0.5, 0.5], [2.0, 1.0, 1.0], 1),  # a full tie: the first index
        ([3.0, 2.0, 1.0], [0.0, 0.0, 9.0], 2),  # cost before travel
    ],
)
def test_rank_pick(costs, dists, want):
    assert int(GTOPlanner.rank_pick(t64(costs), t64(dists))) == want
    assert int(JaxPlanner.rank_pick(jnp.asarray(costs), jnp.asarray(dists))) == want


def _check_plan(got, want):
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-8, rtol=0)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=1e-9, atol=0)
    assert got[0].shape == (9, T) and got[1].shape == (9, T - 1) and got[2].shape == (1,)


def test_plan_goalset_field_mode_matches_jax(setup):
    jr, pr, obs, tf_goal, q_sols, _, field = setup
    kw = dict(T=T, iterations=3, single_pass=True, coarse_iterations=2, final_trust=True,
              goal_coherence=2.0, standoff_distance=-0.1)
    jp, pp = JaxPlanner(jr, "hand", "hand", **kw), GTOPlanner(pr, "hand", "hand", **kw)
    args = (QC, tf_goal[0], 0.5 * field, field, obs.base_position)
    want = jp.plan_goalset(*args, q_solutions=q_sols[0].T, axis_standoff="z")
    got = pp.plan_goalset(*args, q_solutions=q_sols[0].T, axis_standoff="z")
    _check_plan(got, want)
    assert int(pp._last_rank_pick) == int(jp._last_rank_pick)
    # plan: one goal, the scene field zero
    one = pp.plan(QC, tf_goal[0, 1], field, obs.base_position, q_solution=q_sols[0, 1], axis_standoff="z")
    same = pp.plan_goalset(QC, tf_goal[0, 1:2], np.zeros_like(field), field, obs.base_position,
                           q_solutions=q_sols[0, 1][:, None], axis_standoff="z")
    for a, b in zip(one, same):
        np.testing.assert_array_equal(a, b)


def test_plan_goalset_points_mode_matches_jax(setup):
    jr, pr, obs, tf_goal, q_sols, sets, _ = setup
    kw = dict(T=T, iterations=3, single_pass=True, obstacle_mode="points", sdf_epsilon=0.03,
              standoff_distance=-0.1)
    jp, pp = JaxPlanner(jr, "hand", "hand", **kw), GTOPlanner(pr, "hand", "hand", **kw)
    q_cands = q_sols[0, :2].T  # two candidates for three goals: no goal alignment
    want = jp.plan_goalset(
        QC, tf_goal[0, :3], None, None, obs.base_position, q_solutions=q_cands, axis_standoff="z",
        interpolate=False, goal_capacity=4, scene_obstacle=jax_sets_of(obs, 0)[0],
        scene_target=jax_sets_of(obs, 0)[1],
    )
    got = pp.plan_goalset(
        QC, tf_goal[0, :3], None, None, obs.base_position, q_solutions=q_cands, axis_standoff="z",
        interpolate=False, goal_capacity=4, scene_obstacle=sets[0][0], scene_target=sets[0][1],
    )
    _check_plan(got, want)
