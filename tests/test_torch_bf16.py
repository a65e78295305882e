"""bf16 field tables against the JAX package: `VoxelGrid.pack(dtype=bf16)`
bit for bit (from float32 and from float64 fields), K4's plain version on
bf16 rows (float32 points, the rows upcast after the gather) against the
JAX closed-form lookup to 1e-6 relative, the planner's field_dtype=bf16
goal-set plan (per-problem stacked bf16 tables, float64 solve) within 1e-5,
and the bench's bf16 flavour (its table and its gather bytes)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grasptrajopt_tpu.ops import interp as jinterp
from grasptrajopt_tpu.planning.gto_planner import GTOPlanner as JaxPlanner
from grasptrajopt_tpu_torch import bench as pbench
from grasptrajopt_tpu_torch.ops import interp
from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner
from grasptrajopt_tpu_torch.testing import make_synthetic_gto_robot
from torch_parity import GOALSET_KW as KW
from torch_parity import goalset_problem, make_jax_synth_robot, np_, port_robot, t64


@pytest.fixture(scope="module")
def robots():
    jr = make_jax_synth_robot(points_per_link=10)
    return jr, port_robot(jr)


def _fields(jr, dtype):
    rng = np.random.default_rng(12)
    return rng.uniform(-0.05, 0.2, size=(2, jr.grid.size)).astype(dtype)


def _bits(a):
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_packed_table_bit_identical(robots, dtype):
    jr, pr = robots
    fields = _fields(jr, dtype)
    for f in fields:
        want = jr.grid.pack(jnp.asarray(f), dtype=jnp.bfloat16)
        got = pr.grid.pack(torch.as_tensor(f), torch.bfloat16)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(want.shape)
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), _bits(want))
    # the float32 table unchanged without a dtype
    assert pr.grid.pack(torch.as_tensor(fields[0])).dtype == torch.as_tensor(fields[0]).dtype


def test_bf16_lookup_matches_jax(robots):
    jr, pr = robots
    g = jr.grid
    f32 = _fields(jr, np.float32)
    tables_j = jnp.concatenate([g.pack(jnp.asarray(f), dtype=jnp.bfloat16) for f in f32])
    tables_p = torch.cat([pr.grid.pack(torch.as_tensor(f), torch.bfloat16) for f in f32])
    rng = np.random.default_rng(4)
    lo = np.asarray(g.origin) - 0.1
    hi = np.asarray(g.origin) + (np.asarray(g.shape) - 1) * g.resolution + 0.1
    pts = rng.uniform(lo, hi, size=(3, 9, 40, 3)).astype(np.float32)
    row = (np.arange(9) >= 6).astype(np.int64)[:, None] * g.size
    x, y, z = (pts[..., i] for i in range(3))
    want = jinterp.field_lookup_packed_soa_grad(
        tables_j, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), jnp.asarray(g.origin, jnp.float32),
        g.shape, g.resolution, row_offset=jnp.asarray(row),
    )
    got = interp.field_lookup_packed_soa_grad(
        tables_p, *(torch.as_tensor(v) for v in (x, y, z)), g.origin, g.shape, g.resolution,
        row_offset=torch.as_tensor(row),
    )
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == torch.float32
        np.testing.assert_allclose(np_(a), b, rtol=1e-6, atol=1e-6 * np.abs(b).max())
    # the same rows in float32 give values within bf16's rounding
    f32_val = interp.field_lookup_packed_soa_grad(tables_p.float(), *(torch.as_tensor(v) for v in (x, y, z)),
                                                  g.origin, g.shape, g.resolution, row_offset=torch.as_tensor(row))
    assert torch.equal(f32_val[0], got[0])


def test_bf16_plan_matches_jax(robots):
    jr, pr = robots
    args = goalset_problem(jr)
    kw = dict(KW, coarse_iterations=2, final_trust=True)
    Qj, cj = JaxPlanner(jr, "hand", "hand", field_dtype=jnp.bfloat16, **kw).plan_goalset_batch(
        *(jnp.asarray(a) for a in args), axis_standoff="z"
    )
    planner = GTOPlanner(pr, "hand", "hand", field_dtype=torch.bfloat16, **kw)
    tables, _ = planner.pack_stacked_fields(t64(args[3]), t64(args[4]))
    assert tables.dtype == torch.bfloat16 and tables.element_size() == 2
    Qp, cp = planner.plan_goalset_batch(*args, axis_standoff="z")
    np.testing.assert_allclose(np_(Qp), np.asarray(Qj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np_(cp), np.asarray(cj), rtol=1e-5, atol=0)


def test_bench_bf16_flavour():
    """The bf16 flavour's table is the default's cast to bf16, its corner
    rows half the bytes, and its solve runs."""
    cfg = pbench.FLAVOURS["bf16"]
    assert cfg.field_dtype == "bfloat16" and pbench.FLAVOURS["default"].field_dtype == "float32"
    robot = make_synthetic_gto_robot(device="cpu", dtype=torch.float32, points_per_link=10)
    bench = pbench.SolveBench(robot, dataclasses.replace(cfg, batch=2, goal_capacity=2, T=12))
    field = torch.as_tensor(pbench.make_cost_field(robot.grid))
    assert bench.table.dtype == torch.bfloat16 and bench.table.element_size() == 2
    assert torch.equal(bench.table, robot.grid.pack(field).repeat(2, 1).to(torch.bfloat16))
    # 2 problems x 12 steps x (2 coarse passes x 50 + 1 fine pass x 100 points) rows of 8 bf16 values
    assert bench.gather_bytes() == 2 * 12 * (2 * 50 + 100) * 8 * 2
    Q, cost, _ = bench.step()
    assert torch.isfinite(Q).all() and torch.isfinite(cost).all()


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_lookup_packed_matches_jax(robots, dtype):
    """VoxelGrid.lookup_packed (the AoS packed lookup) with a row offset,
    on a float64 and a bf16 table, against the JAX grid's."""
    jr, pr = robots
    f = _fields(jr, np.float64)
    jdt, pdt = (jnp.bfloat16, torch.bfloat16) if dtype else (None, None)
    table_j = jnp.concatenate([jr.grid.pack(jnp.asarray(v), dtype=jdt) for v in f])
    table_p = torch.cat([pr.grid.pack(t64(v), pdt) for v in f])
    rng = np.random.default_rng(8)
    g = jr.grid
    lo = np.asarray(g.origin) - 0.1
    hi = np.asarray(g.origin) + (np.asarray(g.shape) - 1) * g.resolution + 0.1
    pts = rng.uniform(lo, hi, size=(5, 30, 3))
    want = g.lookup_packed(table_j, jnp.asarray(pts), row_offset=g.size)
    got = pr.grid.lookup_packed(table_p, t64(pts), row_offset=g.size)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=1e-12, rtol=0)
