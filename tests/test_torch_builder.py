"""The builder stack against the JAX package's, float64 on the CPU, on the
problems of tests/test_builder.py: the block layout (column-major vec /
unvec on non-square blocks), the builder's allocation and its named
constraints, f / h / g and df / ddf / dh / dg (1e-10
relative), the problem classes, the AL-SQP solver (iterates within 1e-8),
the solver interface (seeds and parameters through numpy dicts, the merged
solution, diagnostics), the discrete relax -> round -> polish branch, the
batched ADMM QP solver against the JAX `vmap` (1e-9), and the SciPy
backends (1e-6). f / h / g are bit for bit equal on the problems of plain
arithmetic and within 1e-14 relative where sin / cos enter."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import grasptrajopt_tpu.opt as jopt
import grasptrajopt_tpu_torch.opt as topt
from grasptrajopt_tpu.models import RobotModel as JaxRobot
from grasptrajopt_tpu.models import TaskModel as JaxTask
from grasptrajopt_tpu_torch.models import RobotModel, TaskModel
from torch_parity import np_, t64

VALUE_RTOL = 1e-14
DERIV_RTOL = 1e-10
ITER_TOL = 1e-8
ADMM_TOL = 1e-9
SCIPY_TOL = 1e-6
CPU = torch.device("cpu")

TWO_LINK = """
<robot name="two_link">
  <link name="base"/><link name="upper"/><link name="ee"/>
  <joint name="shoulder" type="revolute">
    <parent link="base"/><child link="upper"/><origin xyz="0 0 0"/>
    <axis xyz="0 0 1"/><limit lower="-2" upper="2" velocity="1.5"/>
  </joint>
  <joint name="elbow" type="revolute">
    <parent link="upper"/><child link="ee"/><origin xyz="1 0 0"/>
    <axis xyz="0 0 1"/><limit lower="-2.5" upper="2.5" velocity="2.5"/>
  </joint>
</robot>
"""

# -- the problems, stated once over either package's array module ----------
# `m` is jax.numpy or torch; each problem returns its builder.


def _builder(m, T=1, robots=(), tasks=()):
    if m is jnp:
        return jopt.OptimizationBuilder(T=T, robots=robots, tasks=tasks)
    return topt.OptimizationBuilder(T=T, robots=robots, tasks=tasks, device=CPU)


def _robot(m, **kw):
    if m is jnp:
        return JaxRobot(urdf_string=TWO_LINK, dtype=jnp.float64, **kw)
    return RobotModel(urdf_string=TWO_LINK, dtype=torch.float64, device=CPU, **kw)


def _task(m, *args, **kw):
    return (JaxTask if m is jnp else TaskModel)(*args, **kw)


def quadratic_linear(m):
    b = _builder(m)
    b.add_decision_variables("x", 3)
    b.add_parameter("target", 3)
    b.add_cost_term("quad", lambda x, p: m.sum((x["x"] - p["target"]) ** 2))
    b.add_equality_constraint("sum1", lambda x, p: m.sum(x["x"]) - 1.0)
    return b


def nonlinear(m):
    b = _builder(m)
    b.add_decision_variables("x", 2)
    b.add_cost_term("nl", lambda x, p: m.sum(m.sin(x["x"])))
    b.add_geq_inequality_constraint("circle", lambda x, p: 1.0 - m.sum(x["x"] ** 2))
    return b


def unconstrained(m):
    b = _builder(m, tasks=[_task(m, "y", dim=1)])
    b.add_cost_term("c", lambda x, p: m.sum(x["y/y/x"] ** 2))
    return b


def discrete(m):
    b = _builder(m, tasks=[_task(m, "slot", dim=2, is_discrete=True)])
    b.add_decision_variables("shift", 1, is_discrete=False)
    target = np.array([2.3, -0.6])
    tgt = jnp.asarray(target) if m is jnp else t64(target)
    b.add_cost_term(
        "fit",
        lambda x, p: m.sum((x["slot/y/x"].reshape(-1) - tgt) ** 2) + (x["shift"].reshape(()) - 0.25) ** 2,
    )
    return b


def toy(m):
    b = _builder(m)
    b.add_decision_variables("x", 2)
    b.add_parameter("target", 2)
    b.add_cost_term("track", lambda x, p: m.sum((x["x"] - p["target"]) ** 2))
    b.add_equality_constraint("fix0", lambda x, p: x["x"][0, 0] - 0.25)
    return b


def robot_param_joint(m):
    robot = _robot(m, time_derivs=[0], param_joints=["elbow"])
    b = _builder(m, T=3, robots=[robot])
    b.add_parameter("target", 1)
    b.add_cost_term("goal", lambda x, p: m.sum((x["two_link/q/x"][:, -1] - p["target"]) ** 2))
    b.enforce_model_limits("two_link")
    return b


def robot_full(m):
    """Every convenience constraint of the builder on a (2, T) / (2, T-1)
    robot problem: Euler coupling, initial and fixed configurations,
    limits with a safety fraction, the velocity limit, the sphere
    collision constraint; a nonlinear cost through FK."""
    robot = _robot(m, time_derivs=[0, 1])
    T = 6
    b = _builder(m, T=T, robots=[robot])
    b.add_parameter("goal", 3)

    def reach(x, p):
        Q = b.get_robot_states_and_parameters(x, p, "two_link")
        pos = robot.get_global_link_position("ee", Q.T)
        return m.sum((pos[-1] - p["goal"].reshape(3)) ** 2) + 0.1 * m.sum(x["two_link/dq/x"] ** 2)

    b.add_cost_term("reach", reach)
    b.add_cost_term("smooth", lambda x, p: m.sum(m.cos(x["two_link/q/x"])))
    b.initial_configuration("two_link", np.array([0.1, -0.2]))
    b.initial_configuration("two_link", time_deriv=1)
    b.fix_configuration("two_link", lambda p: p["goal"].reshape(3)[:2], t=T - 1)
    b.integrate_model_states("two_link", 1, 0.2)
    b.enforce_model_limits("two_link", 0, safe_frac=0.9)
    b.enforce_model_limits("two_link", 1)
    b.add_leq_inequality_constraint("cap", lambda x, p: m.sum(x["two_link/q/x"] ** 2) - 4.0)
    b.sphere_collision_avoidance_constraints("two_link", ["ball"], link_radii=[0.1, 0.1, 0.05])
    return b


TRANSCENDENTAL = {"nonlinear", "robot_full"}
PROBLEMS = {f.__name__: f for f in (quadratic_linear, nonlinear, unconstrained, discrete, toy,
                                    robot_param_joint, robot_full)}


def both(name):
    return PROBLEMS[name](jnp).build(), PROBLEMS[name](torch).build()


def _points(opt, seed, count=3):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=opt.nx), rng.normal(size=opt.np_)) for _ in range(count)]


# -- layout ------------------------------------------------------------------


def test_layout_vec_unvec_identical_on_non_square_blocks():
    rng = np.random.default_rng(0)
    shapes = {"a": (2, 3), "b": (4, 1), "c": (3, 5), "d": (1, 7)}
    jl, tl = jopt.BlockLayout(), topt.BlockLayout()
    for k, (r, c) in shapes.items():
        jl.add(k, r, c)
        tl.add(k, r, c)
    vals = {k: rng.normal(size=s) for k, s in shapes.items()}
    vj = np.asarray(jl.vec(vals, jnp.float64))
    vt = np_(tl.vec(vals, torch.float64, CPU))
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(vt[:2], vals["a"][:, 0])  # column-major
    back_j, back_t = jl.unvec(jnp.asarray(vj)), tl.unvec(t64(vt))
    for k in shapes:
        np.testing.assert_array_equal(np_(back_t[k]), np.asarray(back_j[k]))
        np.testing.assert_array_equal(np_(back_t[k]), vals[k])
    # missing blocks are zero, and the offsets agree
    part = {"b": vals["b"]}
    np.testing.assert_array_equal(np_(tl.vec(part, torch.float64, CPU)), np.asarray(jl.vec(part, jnp.float64)))
    assert [tl.offset(k) for k in shapes] == [jl.offset(k) for k in shapes]
    assert tl.size == jl.size == 2 * 3 + 4 + 3 * 5 + 7


# -- allocation and names ----------------------------------------------------


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_allocation_and_named_terms_match(name):
    jo, to = both(name)
    assert list(to.x_layout.shapes.items()) == list(jo.x_layout.shapes.items())
    assert list(to.p_layout.shapes.items()) == list(jo.p_layout.shapes.items())
    assert to.x_layout.is_discrete == jo.x_layout.is_discrete
    np.testing.assert_array_equal(to.discrete_mask(), jo.discrete_mask())
    for attr in ("cost_terms", "eq_constraints", "ineq_constraints"):
        assert [n for n, _ in getattr(to, attr)] == [n for n, _ in getattr(jo, attr)]


def test_robot_allocation():
    b = topt.OptimizationBuilder(T=10, robots=[_robot(torch, time_derivs=[0, 1])], device=CPU)
    assert b.x_layout.shapes["two_link/q/x"] == (2, 10)
    assert b.x_layout.shapes["two_link/dq/x"] == (2, 9)
    b = topt.OptimizationBuilder(T=5, robots=[_robot(torch, param_joints=["elbow"])], device=CPU)
    assert b.x_layout.shapes["two_link/q/x"] == (1, 5)
    assert b.p_layout.shapes["two_link/q/p"] == (1, 5)
    b = topt.OptimizationBuilder(T=4, tasks=[TaskModel("base_pose", dim=3)], derivs_align=True, device=CPU)
    assert b.x_layout.shapes["base_pose/y/x"] == (3, 4)


# -- values and derivatives --------------------------------------------------


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_values_equal_and_derivatives_agree(name):
    jo, to = both(name)
    # bit for bit where the problem is plain arithmetic; XLA's and torch's
    # sin / cos may differ in the last bit
    rtol = VALUE_RTOL if name in TRANSCENDENTAL else 0.0
    for xn, pn in _points(jo, seed=len(name)):
        xj, pj, xt, pt = jnp.asarray(xn), jnp.asarray(pn), t64(xn), t64(pn)
        for fn in ("f", "h", "g", "v"):
            np.testing.assert_allclose(np_(getattr(to, fn)(xt, pt)), np.asarray(getattr(jo, fn)(xj, pj)),
                                       rtol=rtol, atol=0, err_msg=fn)
        terms_j, terms_t = jo.cost_term_values(xj, pj), to.cost_term_values(xt, pt)
        assert list(terms_t) == list(terms_j)
        for k in terms_j:
            np.testing.assert_allclose(float(terms_t[k]), float(terms_j[k]), rtol=rtol, atol=0, err_msg=k)
        for fn in ("df", "ddf", "dh", "dg"):
            want = np.asarray(getattr(jo, fn)(xj, pj))
            got = np_(getattr(to, fn)(xt, pt))
            assert got.shape == want.shape, fn
            np.testing.assert_allclose(got, want, rtol=DERIV_RTOL, atol=DERIV_RTOL * (1 + np.abs(want).max(initial=0)),
                                       err_msg=fn)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_problem_class_matches(name):
    jo, to = both(name)
    assert to.problem_class == jo.problem_class
    assert to.cost_is_quadratic() == jo.cost_is_quadratic()
    assert to.constraints_are_linear() == jo.constraints_are_linear()


def test_problem_classes_named():
    assert both("quadratic_linear")[1].problem_class == "QuadraticCostLinearConstraints"
    assert both("nonlinear")[1].problem_class == "NonlinearCostNonlinearConstraints"
    assert both("unconstrained")[1].problem_class == "QuadraticCostUnconstrained"
    assert both("discrete")[1].problem_class.startswith("MixedInteger")


def test_as_qp_matches():
    jo, to = both("quadratic_linear")
    pn = np.array([0.3, -0.4, 1.1])
    for got, want in zip(to.as_qp(t64(pn)), jo.as_qp(jnp.asarray(pn))):
        np.testing.assert_allclose(np_(got), np.asarray(want), rtol=DERIV_RTOL, atol=DERIV_RTOL)


# -- the AL-SQP solver -------------------------------------------------------


def _al_problems(m):
    """(f, h, g, x0, config) of tests/test_builder.py's TestALSQP."""
    vec = jnp.asarray if m is jnp else t64
    stack = jnp.stack if m is jnp else torch.stack
    return {
        "equality": (lambda x, p: m.sum(x * x), lambda x, p: stack([x[0] + x[1] - 1.0]), None,
                     np.zeros(2), jopt.ALSQPConfig()),
        "inequality": (lambda x, p: m.sum((x - 2.0) ** 2), None, lambda x, p: 1.0 - x,
                       np.zeros(1), jopt.ALSQPConfig()),
        "sin_nlp": (lambda x, p: m.sum(m.sin(x)) + m.sum(x * x), None,
                    lambda x, p: stack([2.0 - m.sum(x * x)]), np.full(3, 0.5),
                    jopt.ALSQPConfig(outer_iterations=12, inner_iterations=25)),
        "boxed": (lambda x, p: m.sum((x - vec(np.array([1.5, -2.0, 0.3]))) ** 2) + m.prod(x), None, None,
                  np.array([0.1, 0.2, -0.1]), jopt.ALSQPConfig(outer_iterations=3, inner_iterations=10)),
    }


@pytest.mark.parametrize("case", ["equality", "inequality", "sin_nlp", "boxed"])
def test_al_sqp_iterates_match(case):
    fj, hj, gj, x0, cfg = _al_problems(jnp)[case]
    ft, ht, gt, _, _ = _al_problems(torch)[case]
    n = x0.shape[0]
    lo = np.full(n, -1.0 if case == "boxed" else -np.inf)
    hi = np.full(n, 1.0 if case == "boxed" else np.inf)
    xj, ij = jopt.make_al_sqp_solver(fj, hj, gj, cfg)(jnp.asarray(x0), jnp.asarray(lo), jnp.asarray(hi), jnp.zeros(0))
    tcfg = topt.ALSQPConfig(*cfg)
    xt, it = topt.make_al_sqp_solver(ft, ht, gt, tcfg)(t64(x0), t64(lo), t64(hi), t64(np.zeros(0)))
    np.testing.assert_allclose(np_(xt), np.asarray(xj), atol=ITER_TOL)
    for k in ("f", "constraint_violation", "lam", "mu", "rho"):
        np.testing.assert_allclose(np_(it[k]), np.asarray(ij[k]), atol=ITER_TOL, rtol=ITER_TOL, err_msg=k)


def test_al_sqp_singular_step_falls_back_to_the_gradient():
    """A flat direction with zero curvature and zero jitter: the Newton
    matrix is singular, the solve is not finite and the step is the
    gradient's, as in the JAX package."""
    cfg = jopt.ALSQPConfig(outer_iterations=1, inner_iterations=3, jitter=0.0, lambda_init=0.0)
    fj = lambda x, p: (x[0] - 1.0) ** 2 + 0.0 * x[1]
    ft = lambda x, p: (x[0] - 1.0) ** 2 + 0.0 * x[1]
    x0 = np.array([0.0, 0.5])
    xj, _ = jopt.make_al_sqp_solver(fj, config=cfg)(jnp.asarray(x0), -jnp.full(2, jnp.inf), jnp.full(2, jnp.inf),
                                                     jnp.zeros(0))
    xt, _ = topt.make_al_sqp_solver(ft, config=topt.ALSQPConfig(*cfg))(
        t64(x0), t64(np.full(2, -np.inf)), t64(np.full(2, np.inf)), None
    )
    np.testing.assert_allclose(np_(xt), np.asarray(xj), atol=ITER_TOL)
    assert abs(float(xt[0]) - 1.0) < 1e-6 and float(xt[1]) == 0.5


# -- the solver interface ----------------------------------------------------


def _run(solver, params=None, seed=None):
    if params:
        solver.reset_parameters(params)
    if seed:
        solver.reset_initial_seed(seed)
    return solver.solve()


def _same_solution(st, sj, tol):
    assert set(st) == set(sj)
    for k in sj:
        np.testing.assert_allclose(np.asarray(st[k]), np.asarray(sj[k]), atol=tol, err_msg=k)


@pytest.mark.parametrize("name,params,seed", [
    ("toy", {"target": np.array([1.0, 2.0])}, {"x": np.zeros(2)}),
    ("robot_param_joint", {"target": np.array([0.7]), "two_link/q/p": 0.3 * np.ones((1, 3))}, None),
    ("robot_full", {"goal": np.array([0.9, 0.8, 0.0]), "ball_position": np.array([1.2, 0.6, 0.0]),
                    "ball_radii": np.array([0.2])}, {"two_link/q/x": 0.1 * np.ones((2, 6))}),
])
def test_alsqp_solver_matches(name, params, seed):
    jo, to = both(name)
    cfg = jopt.ALSQPConfig(outer_iterations=4, inner_iterations=6)
    sj = _run(jopt.ALSQPSolver(jo).setup(config=cfg), params, seed)
    solver = topt.ALSQPSolver(to).setup(config=topt.ALSQPConfig(*cfg))
    st = _run(solver, params, seed)
    _same_solution(st, sj, ITER_TOL)
    js = jopt.ALSQPSolver(jo).setup(config=cfg)
    _run(js, params, seed)
    assert solver.violated_constraints(tol=1e-9).keys() == js.violated_constraints(tol=1e-9).keys()
    # values at iterates 1e-8 apart, through gradients of order 1
    for k, v in js.evaluate_cost_terms().items():
        assert abs(solver.evaluate_cost_terms()[k] - v) <= 10 * ITER_TOL
    assert abs(solver.evaluate_cost() - js.evaluate_cost()) <= 10 * ITER_TOL
    assert solver.did_solve(1e-3) == js.did_solve(1e-3)
    assert abs(solver.stats()["constraint_violation"] - js.stats()["constraint_violation"]) <= 10 * ITER_TOL


def test_solver_api_on_the_toy_problem():
    _, to = both("toy")
    solver = topt.ALSQPSolver(to).setup()
    sol = _run(solver, {"target": np.array([1.0, 2.0])}, {"x": np.zeros(2)})
    np.testing.assert_allclose(sol["x"].reshape(-1), [0.25, 2.0], atol=1e-5)
    assert solver.did_solve() and solver.violated_constraints() == {}
    assert "fix0" in solver.violated_constraints(xvec=np.zeros(2))
    merged = _run(topt.ALSQPSolver(both("robot_param_joint")[1]).setup(),
                  {"target": np.array([0.7]), "two_link/q/p": 0.3 * np.ones((1, 3))})
    assert merged["two_link/q"].shape == (2, 3)
    np.testing.assert_allclose(merged["two_link/q"][0, -1], 0.7, atol=1e-4)
    np.testing.assert_array_equal(merged["two_link/q"][1], 0.3)
    f = topt.Solver.interpolate(merged["two_link/q"], 2.0)
    np.testing.assert_allclose(f(2.0), merged["two_link/q"][:, -1])


def test_discrete_relax_round_polish_matches():
    jo, to = both("discrete")
    sj = jopt.ALSQPSolver(jo).setup().solve()
    st = topt.ALSQPSolver(to).setup().solve()
    _same_solution(st, sj, ITER_TOL)
    np.testing.assert_allclose(st["slot/y/x"].reshape(-1), [2.0, -1.0], atol=1e-8)
    np.testing.assert_allclose(float(st["shift"].reshape(())), 0.25, atol=1e-6)


def test_admm_qp_solver_matches():
    jo, to = both("toy")
    params = {"target": np.array([1.0, 2.0])}
    sj = _run(jopt.ADMMQPSolver(jo).setup(), params)
    solver = topt.ADMMQPSolver(to).setup()
    st = _run(solver, params)
    _same_solution(st, sj, ADMM_TOL)
    np.testing.assert_allclose(st["x"].reshape(-1), [0.25, 2.0], atol=1e-4)
    assert solver.number_of_iterations() == 200


@pytest.mark.parametrize("name,params", [
    ("toy", {"target": np.array([1.0, 2.0])}),
    ("robot_full", {"goal": np.array([0.9, 0.8, 0.0]), "ball_position": np.array([1.2, 0.6, 0.0]),
                    "ball_radii": np.array([0.2])}),
])
def test_scipy_solver_matches(name, params):
    jo, to = both(name)
    sj = _run(jopt.ScipyMinimizeSolver(jo).setup(), params)
    solver = topt.ScipyMinimizeSolver(to).setup()
    st = _run(solver, params)
    _same_solution(st, sj, SCIPY_TOL)


# -- ADMM, batched -----------------------------------------------------------


def _qp_batch(B=6, n=7, m_eq=2, seed=3):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n))
    P = M @ M.transpose(0, 2, 1) + 2.0 * np.eye(n)
    q = rng.normal(size=(B, n))
    A_eq = rng.normal(size=(B, m_eq, n))
    b_eq = rng.normal(size=(B, m_eq))
    A = np.concatenate([A_eq, np.tile(np.eye(n), (B, 1, 1))], axis=1)
    l = np.concatenate([b_eq, np.full((B, n), -0.4)], axis=1)
    u = np.concatenate([b_eq, np.full((B, n), 0.4)], axis=1)
    return P, q, A, l, u


def test_admm_batched_matches_jax_vmap():
    P, q, A, l, u = _qp_batch()
    want = jax.vmap(lambda *a: jopt.solve_qp_admm(*a))(*(jnp.asarray(a) for a in (P, q, A, l, u)))
    got = topt.solve_qp_admm(*(t64(a) for a in (P, q, A, l, u)))
    for g_, w_ in zip(got[:3], want[:3]):
        np.testing.assert_allclose(np_(g_), np.asarray(w_), atol=ADMM_TOL)
    for k in ("primal_res", "dual_res"):
        assert got[3][k].shape == (P.shape[0],)
        np.testing.assert_allclose(np_(got[3][k]), np.asarray(want[3][k]), atol=ADMM_TOL)


def test_admm_equality_qp_against_kkt():
    """tests/test_builder.py's equality QP: the KKT solution to 1e-4."""
    rng = np.random.default_rng(0)
    M = rng.normal(size=(3, 3))
    P = M @ M.T + 3 * np.eye(3)
    q = rng.normal(size=3)
    a = rng.normal(size=3)
    b = 1.3
    x, *_ = topt.solve_qp_admm(t64(P), t64(q), t64(a[None, :]), t64([b]), t64([b]))
    KKT = np.block([[P, a[:, None]], [a[None, :], np.zeros((1, 1))]])
    sol = np.linalg.solve(KKT, np.concatenate([-q, [b]]))
    np.testing.assert_allclose(np_(x), sol[:3], atol=1e-4)
    # no constraints: the unconstrained minimizer
    x, *_, res = topt.solve_qp_admm(t64(P), t64(q), t64(np.zeros((0, 3))), t64(np.zeros(0)), t64(np.zeros(0)))
    np.testing.assert_allclose(np_(x), np.linalg.solve(P, -q), atol=1e-4)
    assert float(res["primal_res"]) == 0.0


# -- the SciPy box oracle and the one-problem LM -----------------------------


def test_scipy_box_and_solve_box_lm_match():
    from grasptrajopt_tpu.opt.lm import LMConfig as JaxLMConfig
    from grasptrajopt_tpu.opt.scipy_oracle import solve_scipy_box as jax_scipy_box
    from grasptrajopt_tpu_torch.opt.lm import LMConfig
    from grasptrajopt_tpu_torch.opt.scipy_oracle import solve_scipy_box

    A = np.array([[1.0, 0.5, 0.0], [0.2, -1.0, 0.3], [0.0, 0.4, 2.0], [1.0, 1.0, 1.0]])
    tgt = np.array([0.3, -0.2, 0.5, 2.0])

    def res_j(x, p):
        return jnp.asarray(A) @ (x + 0.1 * jnp.sin(x)) - p

    def res_t(x, p):
        return t64(A) @ (x + 0.1 * torch.sin(x)) - p

    val_j = lambda x, p: 0.05 * jnp.sum(x ** 4)
    val_t = lambda x, p: 0.05 * torch.sum(x ** 4)
    x0, lo, hi = np.zeros(3), np.full(3, -0.5), np.full(3, 0.6)
    for vj, vt in ((None, None), (val_j, val_t)):
        xs_j, cs_j = jax_scipy_box(res_j, x0, lo, hi, jnp.asarray(tgt), value_fn=vj)
        xs_t, cs_t = solve_scipy_box(res_t, x0, lo, hi, t64(tgt), value_fn=vt, device=CPU)
        np.testing.assert_allclose(xs_t, xs_j, atol=SCIPY_TOL)
        assert abs(cs_t - cs_j) <= SCIPY_TOL
        xl_j, cl_j, _ = jopt.solve_box_lm(res_j, jnp.asarray(x0), jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(tgt),
                                          value_fn=vj, config=JaxLMConfig(iterations=20))
        xl_t, cl_t, _ = topt.solve_box_lm(res_t, t64(x0), t64(lo), t64(hi), t64(tgt), value_fn=vt,
                                          config=LMConfig(iterations=20))
        np.testing.assert_allclose(np_(xl_t), np.asarray(xl_j), atol=ITER_TOL)
        assert abs(float(cl_t) - float(cl_j)) <= ITER_TOL
