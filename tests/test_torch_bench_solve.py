"""The port's bench problem (`grasptrajopt_tpu_torch.bench`) against the
JAX package's bench.py, float64, at a small size (3 problems of 2 goals,
T = 12, the synthetic arm with 10 points per link):

  - the host helpers (slab distance, eps-band cost field, goal sets) equal
    bench.py's;
  - the IK warm start, with the multistart rescue of a problem whose goals
    are all out of reach (the JAX package's restarts handed across), equals
    bench.py's lines, X0 to 1e-8;
  - the bench solve from the port's warm start equals the JAX
    `solve_batch_shared` on one shared packed table, Q to 1e-8;
  - the quality gates helper equals a direct count.
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from grasptrajopt_tpu.planning.gto_planner import GTOPlanner as JaxPlanner
from grasptrajopt_tpu.planning.ik_solver import IKSolver as JaxIK
from grasptrajopt_tpu.planning.utils import interpolate_waypoints_jnp
from grasptrajopt_tpu.spatial import r2quat
from grasptrajopt_tpu.spatial.quaternion import qangle_deg
from grasptrajopt_tpu.testing import SYNTH_DEFAULT_POSE
from grasptrajopt_tpu_torch import bench as pbench
from grasptrajopt_tpu_torch.planning.ik_solver import IKSolver
from test_torch_multistart import jax_restarts
from torch_parity import make_jax_synth_robot, np_, port_robot, t64

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench as root_bench  # noqa: E402  (the JAX package's bench; numpy at import)

QC = SYNTH_DEFAULT_POSE.astype(np.float64)
CFG = pbench.SolveBenchConfig(batch=3, goal_capacity=2, T=12)
IK_ITERS, SEEDS = 50, 4  # the bench's IK budget: the reachable goals converge


@pytest.fixture(scope="module")
def robots():
    jr = make_jax_synth_robot(points_per_link=10)
    return jr, port_robot(jr)


def test_host_helpers_equal_bench_py(robots):
    jr, pr = robots
    np.testing.assert_array_equal(pbench.make_cost_field(pr.grid), root_bench.make_cost_field(jr.grid))
    pts = np.random.default_rng(0).uniform(-1, 1, size=(500, 3))
    np.testing.assert_array_equal(pbench.slab_signed_distance(pts), root_bench.slab_signed_distance(pts))
    RT = np.eye(4)
    RT[:3, 3] = [0.5, 0.0, 0.2]
    np.testing.assert_array_equal(
        pbench.make_goal_sets(RT, 3, 4, np.random.default_rng(1)),
        root_bench.make_goal_sets(RT, 3, 4, np.random.default_rng(1)),
    )
    goals = pbench.synthetic_goal_sets(3, 2)
    assert goals.dtype == np.float32 and goals.shape == (3, 2, 4, 4)


def _jax_warm_start(jr, tf_goal, T):
    """bench.py:344-382 on the JAX package (4 seeds), float64. Only the
    problem out of reach is rescued: its seeds' costs differ, so both
    packages pick the same winners."""
    B, cap = tf_goal.shape[:2]
    ik = JaxIK(jr, "hand", "hand", collision_avoidance=False, iterations=IK_ITERS, num_seeds=SEEDS)
    qsol, ik_pos, ik_rot, _ = ik.solve_ik_batch(np.tile(QC, (B * cap, 1)), tf_goal.reshape(-1, 4, 4))
    err1 = (ik_pos + 2e-3 * ik_rot).reshape(B, cap)
    hard = np.asarray((ik_pos.reshape(B, cap) > 0.01).all(axis=1))
    assert hard.tolist() == [False, True, False]
    qsol_m, pos_m, rot_m, _ = ik.solve_ik_batch(
        np.tile(QC, (B * cap, 1)), tf_goal.reshape(-1, 4, 4), multistart=True
    )
    err_m = (pos_m + 2e-3 * rot_m).reshape(B, cap)
    err = np.where(hard[:, None], np.asarray(err_m), np.asarray(err1))
    qsol = np.where(np.repeat(hard, cap)[:, None], np.asarray(qsol_m), np.asarray(qsol))
    warm_goal = np.argmin(err, axis=1)
    q_best = qsol.reshape(B, cap, -1)[np.arange(B), warm_goal]
    X0 = np.asarray(jax.vmap(lambda qb: interpolate_waypoints_jnp(jnp.asarray(QC), qb, T))(jnp.asarray(q_best)))
    return X0[..., jr.optimized_joint_indexes], warm_goal


def test_warm_start_with_multistart_rescue_matches_bench_py(robots):
    jr, pr = robots
    # goal 0 of problems 0 and 2: the hand's pose near the start, which the
    # single-seed IK reaches; every other goal 2 m and more out of reach,
    # so each choice of goal and restart is clear of rounding
    q = np.tile(QC, (CFG.batch, CFG.goal_capacity, 1))
    q[..., :7] += np.random.default_rng(5).normal(scale=0.1, size=q[..., :7].shape)
    tf_goal = np.array(jr.get_global_link_transform("hand", jnp.asarray(q)))
    tf_goal[:, 1, 2, 3] += 2.5
    tf_goal[1, 0, 2, 3] += 2.0
    X0_j, warm_j = _jax_warm_start(jr, tf_goal, CFG.T - 2)
    n = CFG.batch * CFG.goal_capacity
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    restarts = np.stack([jax_restarts(jr, keys[i], SEEDS - 1) for i in range(n)])
    ik = IKSolver(pr, "hand", "hand", collision_avoidance=False, iterations=IK_ITERS, num_seeds=SEEDS)
    X0, warm = pbench.warm_start(pr, ik, t64(QC), t64(tf_goal), CFG.T - 2, restarts=t64(restarts))
    np.testing.assert_array_equal(np_(warm), warm_j)
    np.testing.assert_allclose(np_(X0), X0_j, atol=1e-8, rtol=0)


def test_bench_solve_matches_jax_solve_batch_shared(robots):
    jr, pr = robots
    bench = pbench.SolveBench(pr, CFG)
    Q, cost, aux = bench.step()
    assert aux["accepts"].shape == (CFG.batch, CFG.iterations)
    planner = JaxPlanner(
        jr, "hand", "hand", iterations=CFG.iterations, standoff_distance=CFG.standoff_distance,
        single_pass=True, T=CFG.T, coarse_iterations=CFG.coarse_iterations,
        coarse_stride=CFG.coarse_stride, final_trust=True,
    )
    solvers = planner.setup_optimization(goal_size=CFG.goal_capacity, use_standoff=True, axis_standoff="z")
    field = jnp.asarray(root_bench.make_cost_field(jr.grid), jnp.float64)
    packed = jnp.concatenate([jr.grid.pack(field), jr.grid.pack(field)], axis=0)
    np.testing.assert_array_equal(np_(bench.table), np.asarray(packed))
    B = CFG.batch
    params = {
        "q_param": jnp.tile(jnp.asarray(QC[7:]), (B, 1)),
        "tf_goal": jnp.asarray(np_(bench.tf_goal)),
        "goal_mask": jnp.ones((B, CFG.goal_capacity), bool),
        "base_position": jnp.zeros((B, 3)),
    }
    Qj, cj, _ = solvers.solve_batch_shared(
        jnp.tile(jnp.asarray(QC[:7]), (B, 1)), jnp.asarray(np_(bench.X0)), params, {"packed_fields": packed}
    )
    np.testing.assert_allclose(np_(Q), np.asarray(Qj), atol=1e-8, rtol=0)
    np.testing.assert_allclose(np_(cost), np.asarray(cj), rtol=1e-9, atol=0)
    gates = bench.gates(Q)
    assert set(gates) == {
        "reached_frac", "collision_frac", "err_pos_median", "err_pos_p90",
        "err_rot_median_deg", "max_inside_points",
    }


def test_quality_gates_equal_a_direct_count():
    rng = np.random.default_rng(2)
    B, cap, T, P = 6, 3, 5, 40
    T_end = np.tile(np.eye(4), (B, 1, 1))
    T_end[:, :3, 3] = rng.uniform(0.3, 0.6, size=(B, 3))
    tf_goal = np.tile(T_end[:, None], (1, cap, 1, 1))
    tf_goal[..., :3, 3] += rng.normal(scale=0.01, size=(B, cap, 3))
    for b in range(B):
        for g in range(cap):  # turn each goal by up to ~8 degrees about z
            a = rng.uniform(-0.14, 0.14)
            tf_goal[b, g, :3, :3] = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    pts = rng.uniform([0.1, -0.7, 0.05], [1.0, 0.7, 0.2], size=(B, T, P, 3))
    got = pbench.quality_gates(T_end, tf_goal, pts)

    d = np.linalg.norm(tf_goal[:, :, :3, 3] - T_end[:, None, :3, 3], axis=-1)
    rot = np.asarray(qangle_deg(r2quat(jnp.asarray(tf_goal[..., :3, :3])),
                                r2quat(jnp.asarray(np.broadcast_to(T_end[:, None, :3, :3], (B, cap, 3, 3))))))
    reached = [any(d[b, g] < 0.01 and rot[b, g] < 5.0 for g in range(cap)) for b in range(B)]
    counts = np.zeros((B, T), int)
    for b in range(B):
        for t in range(T):
            for p in pts[b, t]:
                counts[b, t] += (0.2 < p[0] < 0.9) and (-0.6 < p[1] < 0.6) and (0.10 < p[2] < 0.15)
    best = np.argmin(d + 2e-3 * rot, axis=1)
    assert 0 < sum(reached) < B
    assert got["reached_frac"] == np.mean(reached)
    assert got["collision_frac"] == np.mean((counts > 5).any(axis=1))
    assert got["max_inside_points"] == counts.max()
    assert got["err_pos_median"] == pytest.approx(np.median(d[np.arange(B), best]), abs=1e-12)
    assert got["err_pos_p90"] == pytest.approx(np.quantile(d[np.arange(B), best], 0.9), abs=1e-12)
    assert got["err_rot_median_deg"] == pytest.approx(np.median(rot[np.arange(B), best]), abs=1e-5)
