"""The SDF field program against the JAX package's, float64 on the CPU,
on the synthetic tabletop field of the synthetic arm's grid: values,
gradients and Hessians at random points in and around the table slab
within 1e-10; the Hessian symmetric with zero pure second derivatives
inside a cell; the gradient agrees with K4's closed form (its plain
version on the CPU) at the same points."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grasptrajopt_tpu.fields.sdf_program import make_sdf_program as jax_program
from grasptrajopt_tpu.fields.sdf_program import sdf_value_jac_hess as jax_vjh
from grasptrajopt_tpu.testing import make_synthetic_scene_field as jax_scene_field
from grasptrajopt_tpu_torch.fields import make_sdf_program, sdf_value_jac_hess
from grasptrajopt_tpu_torch.ops.interp import field_lookup_packed_soa_grad
from grasptrajopt_tpu_torch.testing import make_synthetic_gto_robot, make_synthetic_scene_field
from torch_parity import make_jax_synth_robot, np_, t64

TOL = 1e-10


@pytest.fixture(scope="module")
def fields():
    jr = make_jax_synth_robot(points_per_link=1)
    tr = make_synthetic_gto_robot(device="cpu", dtype=torch.float64, points_per_link=1)
    field = make_synthetic_scene_field(tr)
    np.testing.assert_array_equal(field, jax_scene_field(jr))
    return jr, tr, field


def _points(n=400, seed=0):
    """Points over the table slab (x 0.3-0.9, z 0.38-0.42) and around it,
    off the cell faces (5 cm cells: a face is where a coordinate is a
    multiple of 0.05 from the grid origin)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.2, 1.0, n), rng.uniform(-0.3, 0.3, n), rng.uniform(0.3, 0.5, n)], axis=1)


def test_value_jac_hess_match(fields):
    jr, tr, field = fields
    pts = _points()
    want = jax_vjh(jr.grid, jnp.asarray(field, jnp.float64), jnp.asarray(pts))
    got = sdf_value_jac_hess(tr.grid, t64(field), t64(pts))
    for g_, w_, name in zip(got, want, ("value", "jacobian", "hessian")):
        assert tuple(g_.shape) == tuple(w_.shape)
        np.testing.assert_allclose(np_(g_), np.asarray(w_), atol=TOL, rtol=TOL, err_msg=name)
    H = np_(got[2])
    np.testing.assert_allclose(H, H.transpose(0, 2, 1), atol=TOL)
    np.testing.assert_array_equal(np.diagonal(H, axis1=1, axis2=2), 0.0)
    assert np.abs(np_(got[1])).max() > 0.1  # the points see the slab


def test_single_point_program_matches(fields):
    jr, tr, field = fields
    fj = jax_program(jr.grid, jnp.asarray(field, jnp.float64))
    ft = make_sdf_program(tr.grid, t64(field))
    for p in _points(5, seed=3):
        for a, b in zip(ft, fj):
            np.testing.assert_allclose(np_(a(t64(p))), np.asarray(b(jnp.asarray(p))), atol=TOL, rtol=TOL)


def test_gradient_agrees_with_k4_closed_form(fields):
    _, tr, field = fields
    g = tr.grid
    pts = t64(_points(seed=5))
    vals, jac, _ = sdf_value_jac_hess(g, t64(field), pts)
    k4 = field_lookup_packed_soa_grad(g.pack(t64(field)), pts[:, 0], pts[:, 1], pts[:, 2], g.origin, g.shape,
                                      g.resolution)
    np.testing.assert_allclose(np_(k4[0]), np_(vals), atol=TOL)
    np.testing.assert_allclose(np.stack([np_(v) for v in k4[1:]], axis=1), np_(jac), atol=TOL)
