"""The grasp trajectory NLP through the builder DSL at a reduced size
(synth7 at 4 points per link, T = 8, standoff at step 5), float64 on the
CPU: the port's problem (`testing.make_dsl_trajectory_problem`) against
the same problem stated through the JAX package's DSL, as
tests/test_builder_fullscale.py states it at T = 50: f (1e-12 relative),
its gradient and its Hessian (1e-10) at the seed and at random points;
`ALSQPSolver` at 2 outer x 4 inner iterations against the JAX solve (the
iterates within 1e-7); and, in the port only, the formulation check of
the full-scale test: the DSL cost at the structured planner's solution
equals that planner's cost (1e-6 relative)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grasptrajopt_tpu.opt import ALSQPConfig as JaxALSQPConfig
from grasptrajopt_tpu.opt import ALSQPSolver as JaxALSQPSolver
from grasptrajopt_tpu.opt import OptimizationBuilder as JaxBuilder
from grasptrajopt_tpu.spatial import invt as jinvt
from grasptrajopt_tpu.spatial import transform_points as jtransform_points
from grasptrajopt_tpu.testing import SYNTH_LINK_EE, SYNTH_LINK_GRIPPER
from grasptrajopt_tpu.testing import make_synthetic_gto_robot as jax_synth_robot
from grasptrajopt_tpu_torch.opt import ALSQPConfig, ALSQPSolver
from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner
from grasptrajopt_tpu_torch.testing import (
    SYNTH_DEFAULT_POSE,
    make_dsl_trajectory_problem,
    make_synthetic_goal,
    make_synthetic_gto_robot,
    make_synthetic_scene_field,
)
from torch_parity import np_, t64

T = 8
STANDOFF_OFFSET = -3
POINTS_PER_LINK = 4
F_RTOL = 1e-12
DERIV_TOL = 1e-10
ITER_TOL = 1e-7
CFG = dict(outer_iterations=2, inner_iterations=4)


def jax_dsl_problem(robot, field, tf_goal, qc, t_standoff, dt):
    """tests/test_builder_fullscale.py's problem at horizon T (its
    build_dsl_problem and constraints, with T, the standoff step and dt as
    arguments)."""
    name = robot.get_name()
    builder = JaxBuilder(T=T, robots=[robot])
    gpts = jnp.asarray(robot.surface_pc_map[SYNTH_LINK_GRIPPER].points, jnp.float64)
    ee_frame = robot.frame_of(SYNTH_LINK_EE)
    grip_frame = robot.frame_of(SYNTH_LINK_GRIPPER)
    pose_standoff = np.eye(4)
    pose_standoff[2, 3] = -0.1
    pose_standoff = jnp.asarray(pose_standoff)
    grid = robot.grid
    field_j = jnp.asarray(field, jnp.float64)
    tf_goal = jnp.asarray(tf_goal, jnp.float64)

    def goal_cost(x, p):
        Q = builder.get_robot_states_and_parameters(x, p, name)

        def diffs(q_full, tf):
            frames = robot.fk_all(q_full)
            gripper_tf = jinvt(frames[ee_frame]) @ frames[grip_frame]
            pts_cur = jtransform_points(frames[grip_frame], gpts)
            return pts_cur - jtransform_points(tf @ gripper_tf, gpts)

        d_final = diffs(Q[:, T - 1], tf_goal)
        d_stand = diffs(Q[:, t_standoff], tf_goal @ pose_standoff)
        return jnp.sum(d_final**2) + jnp.sum(d_stand**2)

    def obstacle_cost(x, p):
        Q = builder.get_robot_states_and_parameters(x, p, name)
        pts = robot.fk_surface_points(Q.T)
        return 10.0 * jnp.sum(grid.lookup(field_j, pts, "trilinear") ** 2)

    def velocity_cost(x, p):
        dq = x[robot.state_optimized_name(1)]
        return 0.01 * jnp.sum(dq * dq)

    builder.add_cost_term("goal", goal_cost)
    builder.add_cost_term("obstacle", obstacle_cost)
    builder.add_cost_term("velocity", velocity_cost)
    qc_opt = qc[np.asarray(robot.optimized_joint_indexes)]
    builder.initial_configuration(name, qc_opt)
    builder.initial_configuration(name, np.zeros(robot.num_opt_joints), time_deriv=1)
    builder.integrate_model_states(name, 1, dt)
    builder.enforce_model_limits(name, 0)
    return builder.build()


@pytest.fixture(scope="module")
def problems():
    tr = make_synthetic_gto_robot(device="cpu", dtype=torch.float64, points_per_link=POINTS_PER_LINK)
    jr = jax_synth_robot(dtype=jnp.float64, points_per_link=POINTS_PER_LINK)
    field = make_synthetic_scene_field(tr)
    tf_goal = make_synthetic_goal(0)
    qc = SYNTH_DEFAULT_POSE.astype(np.float64)
    port = make_dsl_trajectory_problem(tr, field, tf_goal, qc, T=T, standoff_offset=STANDOFF_OFFSET)
    jopt = jax_dsl_problem(jr, field, tf_goal, qc, port.t_standoff, port.dt)
    return tr, jr, field, tf_goal, qc, port, jopt


def _points(port, jopt):
    """The seed point and random points about it, with the parameters."""
    x0 = port.opt.x_layout.vec(port.seed, torch.float64, "cpu")
    p = port.opt.p_layout.vec(port.params, torch.float64, "cpu")
    np.testing.assert_array_equal(np_(p), np.asarray(jopt.p_layout.vec(port.params, jnp.float64)))
    rng = np.random.default_rng(11)
    xs = [np_(x0)] + [np_(x0) + rng.normal(scale=0.6, size=x0.shape[0]) for _ in range(3)]
    return xs, np_(p)


def test_problem_layout_matches(problems):
    *_, port, jopt = problems
    assert list(port.opt.x_layout.shapes.items()) == list(jopt.x_layout.shapes.items())
    assert list(port.opt.p_layout.shapes.items()) == list(jopt.p_layout.shapes.items())
    assert port.opt.nx == 7 * T + 7 * (T - 1)
    for attr in ("cost_terms", "eq_constraints", "ineq_constraints"):
        assert [n for n, _ in getattr(port.opt, attr)] == [n for n, _ in getattr(jopt, attr)]


def test_cost_gradient_hessian_match(problems):
    *_, port, jopt = problems
    xs, p = _points(port, jopt)
    saw_obstacle = False
    for x in xs:
        xt, pt, xj, pj = t64(x), t64(p), jnp.asarray(x), jnp.asarray(p)
        np.testing.assert_allclose(float(port.opt.f(xt, pt)), float(jopt.f(xj, pj)), rtol=F_RTOL)
        for name, v in jopt.cost_term_values(xj, pj).items():
            np.testing.assert_allclose(float(port.opt.cost_term_values(xt, pt)[name]), float(v), rtol=F_RTOL,
                                       atol=1e-300, err_msg=name)
        saw_obstacle |= float(jopt.cost_term_values(xj, pj)["obstacle"]) > 0.0
        np.testing.assert_allclose(np_(port.opt.h(xt, pt)), np.asarray(jopt.h(xj, pj)), rtol=F_RTOL, atol=1e-15)
        np.testing.assert_allclose(np_(port.opt.g(xt, pt)), np.asarray(jopt.g(xj, pj)), rtol=F_RTOL, atol=1e-15)
        for fn in ("df", "ddf"):
            want = np.asarray(getattr(jopt, fn)(xj, pj))
            np.testing.assert_allclose(np_(getattr(port.opt, fn)(xt, pt)), want, rtol=DERIV_TOL,
                                       atol=DERIV_TOL * np.abs(want).max(), err_msg=fn)
    assert saw_obstacle  # the field term is live at these points


def test_alsqp_solve_matches_jax(problems):
    *_, port, jopt = problems
    js = JaxALSQPSolver(jopt).setup(port.lo, port.hi, JaxALSQPConfig(**CFG))
    ts = ALSQPSolver(port.opt).setup(port.lo, port.hi, ALSQPConfig(**CFG))
    for s in (js, ts):
        s.reset_initial_seed(port.seed)
        s.reset_parameters(port.params)
    sj, st = js.solve(), ts.solve()
    assert set(st) == set(sj)
    for k in sj:
        np.testing.assert_allclose(np.asarray(st[k]), np.asarray(sj[k]), atol=ITER_TOL, err_msg=k)
    assert abs(ts.stats()["constraint_violation"] - js.stats()["constraint_violation"]) <= ITER_TOL
    assert ts.violated_constraints(tol=1e-6).keys() == js.violated_constraints(tol=1e-6).keys()


def test_dsl_cost_at_the_structured_solution(problems):
    """(a) of the full-scale test, in the port: the DSL states the
    structured planner's objective."""
    tr, _, field, tf_goal, qc, port, _ = problems
    planner = GTOPlanner(tr, SYNTH_LINK_EE, SYNTH_LINK_GRIPPER, iterations=30, T=T,
                         standoff_offset=STANDOFF_OFFSET)
    solve = planner.setup_optimization(1, True, "z").solve_batch_shared
    qc_opt = t64(qc[tr.optimized_joint_indexes])
    params = {
        "q_param": t64(qc[tr.parameter_joint_indexes])[None],
        "tf_goal": t64(tf_goal)[None, None],
        "goal_mask": torch.ones((1, 1), dtype=torch.bool),
        "base_position": torch.zeros((1, 3), dtype=torch.float64),
    }
    f = t64(field)
    Q_ref, c_ref, _ = solve(qc_opt[None], qc_opt.expand(T - 2, -1)[None], params,
                            {"packed_fields": planner.field_table(f, f)})
    q_blocks = np_(Q_ref[0]).T
    x_ref = port.opt.x_layout.vec(
        {tr.state_optimized_name(0): q_blocks,
         tr.state_optimized_name(1): (q_blocks[:, 1:] - q_blocks[:, :-1]) / port.dt},
        torch.float64, "cpu",
    )
    p = port.opt.p_layout.vec(port.params, torch.float64, "cpu")
    np.testing.assert_allclose(float(port.opt.f(x_ref, p)), float(c_ref[0]), rtol=1e-6)
