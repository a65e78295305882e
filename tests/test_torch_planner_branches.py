"""The planner's obstacle-term branches against the JAX package, float64,
through `plan_goalset_batch` (B = 2 problems with their own fields, a
masked goal slot, warm starts; the synthetic arm, 10 points per link, T =
12, single pass, 3 iterations): field_term=False (the JAX package's
per-step field residual; in the port the same whole-trajectory term as
field_term=True, one K4 lookup a pass), interp='nearest' (the unpacked
fields at the floor-indexed cell, zero gradient) and
collision_avoidance=False (no obstacle term). Q to 1e-8, cost to 1e-9
relative; field_term=False equals field_term=True in the port to 1e-12."""

import numpy as np
import pytest

import jax.numpy as jnp

from grasptrajopt_tpu.planning.gto_planner import GTOPlanner as JaxPlanner
from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner
from torch_parity import GOALSET_KW as KW
from torch_parity import goalset_problem, make_jax_synth_robot, np_, port_robot


@pytest.fixture(scope="module")
def setup():
    jr = make_jax_synth_robot(points_per_link=10)
    return jr, port_robot(jr), goalset_problem(jr)


def plan_both(setup, **kw):
    jr, pr, args = setup
    Qj, cj = JaxPlanner(jr, "hand", "hand", **KW, **kw).plan_goalset_batch(
        *(jnp.asarray(a) for a in args), axis_standoff="z"
    )
    Qp, cp = GTOPlanner(pr, "hand", "hand", **KW, **kw).plan_goalset_batch(*args, axis_standoff="z")
    return np.asarray(Qj), np.asarray(cj), np_(Qp), np_(cp)


@pytest.mark.parametrize("kw", [
    {"field_term": False}, {"interp": "nearest"}, {"collision_avoidance": False},
], ids=["field_term_off", "nearest", "no_collision"])
def test_branch_matches_jax(setup, kw):
    Qj, cj, Qp, cp = plan_both(setup, **kw)
    assert np.isfinite(Qp).all()
    np.testing.assert_allclose(Qp, Qj, atol=1e-8, rtol=0)
    np.testing.assert_allclose(cp, cj, rtol=1e-9, atol=0)


def test_field_term_off_equals_on(setup):
    _, pr, args = setup
    on = GTOPlanner(pr, "hand", "hand", **KW).plan_goalset_batch(*args, axis_standoff="z")
    off = GTOPlanner(pr, "hand", "hand", field_term=False, **KW).plan_goalset_batch(*args, axis_standoff="z")
    for a, b in zip(on, off):
        np.testing.assert_allclose(np_(a), np_(b), atol=1e-12, rtol=0)
    none = GTOPlanner(pr, "hand", "hand", collision_avoidance=False, **KW).plan_goalset_batch(*args, axis_standoff="z")
    assert np.abs(np_(none[0]) - np_(on[0])).max() > 1e-4  # the field term matters here


def test_branches_refuse_the_coarse_phase(setup):
    _, pr, _ = setup
    for kw in ({"field_term": False}, {"interp": "nearest"}, {"collision_avoidance": False}):
        with pytest.raises(NotImplementedError):
            GTOPlanner(pr, "hand", "hand", coarse_iterations=2, **KW, **kw).setup_optimization(3, True, "z")
    with pytest.raises(ValueError):
        GTOPlanner(pr, "hand", "hand", interp="cubic")
