"""The IK screen's collision term against the JAX package, float64
(ik_collision_parity.py): multistart with the JAX restarts, point cost,
trilinear (K4's plain version, its closed-form gradient) and nearest
(a floor-indexed gather, zero gradient). q to 1e-8, col_cost to 1e-10.

On a cell face the two packages' gradients differ by design: the JAX
IKSolver differentiates its trilinear lookup by autodiff, which takes half
of the clip's derivative there, while the port's term is K4's closed form,
which takes all of it, as the JAX package's own closed-form lookup
(`field_lookup_packed_soa_grad`, the planner's field term) does. The last
test pins that down; away from faces (measure zero) the two agree."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grasptrajopt_tpu.ops import interp as jinterp
from grasptrajopt_tpu_torch.ops import interp
from grasptrajopt_tpu_torch.planning.ik_solver import IKSolver
from ik_collision_parity import BASE, QC, assert_match, robots_and_field, solve_both
from torch_parity import jax_ik_restarts, np_, t64


@pytest.fixture(scope="module")
def setup():
    return robots_and_field()


def test_trilinear_term_matches_jax(setup):
    jr, pr, field, goals = setup
    before = interp.field_lookup_launches
    want, got, ik = solve_both(jr, pr, field, goals, multistart=True)
    assert interp.field_lookup_launches == before  # CPU tensors take the plain K4
    assert_match(want, got)
    assert (got[3] > 0).all()
    # the term moves the solution: without it the same seeds land elsewhere
    ik.collision_avoidance = False
    ik.setup_optimization()
    restarts = t64(jax_ik_restarts(jr, len(goals), ik.num_seeds, 0))
    q_free = ik.solve_ik_batch(t64(QC), t64(goals), multistart=True, restarts=restarts)[0]
    assert np.abs(np_(q_free) - got[0]).max() > 1e-3


def test_nearest_term_matches_jax(setup):
    jr, pr, field, goals = setup
    want, got, _ = solve_both(jr, pr, field, goals, multistart=True, interp="nearest")
    assert_match(want, got)


def test_single_goal_solve(setup):
    jr, pr, field, goals = setup
    ik = IKSolver(pr, "hand", "hand", iterations=3)
    q, ep, er, col = ik.solve_ik(t64(QC), t64(goals[1]), t64(field), BASE, verbose=False)
    qb, epb, erb, colb = ik.solve_ik_batch(t64(QC), t64(goals[1:2]), t64(field), BASE)
    assert torch.equal(q, qb[0]) and (ep, er, col) == (float(epb[0]), float(erb[0]), float(colb[0]))
    want_col, _ = jr.compute_plan_cost(np_(q)[:, None], field, BASE)
    np.testing.assert_allclose(col, want_col, atol=1e-10, rtol=0)
    np.testing.assert_allclose(np_(ik.solve_fk(np_(q))), np.asarray(jr.get_global_link_transform("hand", jnp.asarray(np_(q)))), atol=1e-12)


def test_gradient_on_cell_faces(setup):
    """K4 (the port) equals the JAX closed form everywhere; the JAX autodiff
    of the packed lookup equals it except where a coordinate lands exactly
    on a face ((y - origin) / resolution an integer), where it is half of
    it along that axis."""
    jr, _, field, _ = setup
    g = jr.grid
    packed = np.asarray(g.pack(jnp.asarray(field)))
    rng = np.random.default_rng(5)
    cells = rng.integers(1, np.asarray(g.shape) - 2, size=(60, 3))
    pts = np.asarray(g.origin) + (cells + rng.uniform(0.1, 0.9, size=(60, 3))) * g.resolution
    pts[:40, 1] = np.asarray(g.origin)[1] + cells[:40, 1] * g.resolution  # y on a face, up to rounding
    x, y, z = (pts[:, i] for i in range(3))
    u = (y - g.origin[1]) * (1.0 / g.resolution)
    on_face = u == np.floor(u)
    assert 5 <= on_face.sum() < 40
    got = interp.field_lookup_packed_soa_grad(t64(packed), t64(x), t64(y), t64(z), g.origin, g.shape, g.resolution)
    closed = jinterp.field_lookup_packed_soa_grad(
        jnp.asarray(packed), jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), jnp.asarray(g.origin), g.shape, g.resolution
    )
    for a, b in zip(got, closed):
        np.testing.assert_allclose(np_(a), np.asarray(b), atol=1e-12, rtol=0)
    gy_autodiff = np.asarray(jax.vmap(jax.grad(lambda yy, xx, zz: jinterp.field_lookup_trilinear_packed_soa(
        jnp.asarray(packed), xx, yy, zz, jnp.asarray(g.origin), g.shape, g.resolution)))(
        jnp.asarray(y), jnp.asarray(x), jnp.asarray(z)))
    gy = np_(got[2])
    assert np.abs(gy[on_face]).min() > 0
    np.testing.assert_allclose(gy_autodiff[~on_face], gy[~on_face], atol=1e-12, rtol=0)
    np.testing.assert_allclose(gy_autodiff[on_face], 0.5 * gy[on_face], atol=1e-12, rtol=0)
