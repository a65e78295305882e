"""The port's serving stream (`grasptrajopt_tpu_torch.parallel`) and the
serving demo (`grasptrajopt_tpu_torch.throughput_serving`) against the JAX
package, on the CPU:

  - the four cases of tests/test_parallel.py::TestStreaming on the port;
  - `PlanStream` around the port's `solve_batch_stacked` (the demo's
    server: the synthetic arm at 8 points per link, float64, 2 iterations
    to keep the CPU solves short) gives the synchronous loop's plans and
    costs bit for bit, at a depth below and above the request count;
  - the demo's `make_request` equals the JAX demo's numpy construction
    (examples/throughput_serving.py, restated here);
  - one request through the JAX `solve_batch` (per-problem tables, vmap)
    and the port's server (one stacked table) on the JAX demo's robot
    (the server's robot equals the JAX one carried across by
    `robot_from_numpy`): plans within 1e-6 rad, costs within 1e-9
    relative, float64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grasptrajopt_tpu.planning.gto_planner import GTOPlanner as JaxPlanner
from grasptrajopt_tpu.testing import (
    SYNTH_DEFAULT_POSE,
    SYNTH_LINK_EE,
    SYNTH_LINK_GRIPPER,
    make_synthetic_goal,
)
from grasptrajopt_tpu.testing import make_synthetic_gto_robot as jax_synth
from grasptrajopt_tpu.testing import make_synthetic_scene_field as jax_field
from grasptrajopt_tpu_torch import throughput_serving as serving
from grasptrajopt_tpu_torch.parallel import PlanStream, stream_map
from grasptrajopt_tpu_torch.convert import robot_from_numpy
from torch_parity import jax_robot_state, np_

ITERATIONS, GOALS, BATCH = 10, 4, 2  # the demo's iterations and goals, 2 problems a request


class TestStreaming:
    """The port's stream_map / PlanStream keep results and their order
    exactly (they only change when the host waits)."""

    def test_stream_map_matches_sequential(self):
        def f(x):
            return x * 2.0 + 1.0

        batches = [torch.full((4,), float(i)) for i in range(7)]
        seq = [f(b) for b in batches]
        for depth in (1, 2, 4):
            got = list(stream_map(f, batches, inflight=depth))
            assert len(got) == len(seq)
            for a, b in zip(got, seq):
                torch.testing.assert_close(a, b, rtol=0, atol=0)

    def test_stream_map_tuple_args_and_pytree_results(self):
        def f(x, y):
            return {"s": x + y, "d": x - y}

        inputs = [(torch.ones(3) * i, torch.ones(3)) for i in range(5)]
        outs = list(stream_map(f, inputs, inflight=3))
        for i, o in enumerate(outs):
            np.testing.assert_allclose(o["s"].numpy(), i + 1.0)
            np.testing.assert_allclose(o["d"].numpy(), i - 1.0)

    def test_plan_stream_submit_drain_order(self):
        def f(x):
            return torch.sum(x) * 3.0

        stream = PlanStream(f, inflight=2)
        retired = []
        for i in range(6):
            retired.extend(stream.submit(torch.full((2,), float(i))))
        assert len(retired) == 4  # the depth bound forced 4 retirements
        retired.extend(stream.drain())
        assert stream.submitted == stream.completed == 6
        np.testing.assert_allclose([float(r) for r in retired], [6.0 * i for i in range(6)])

    def test_invalid_depth_raises(self):
        with pytest.raises(ValueError):
            PlanStream(lambda x: x, inflight=0)
        with pytest.raises(ValueError):
            list(stream_map(lambda x: x, [1], inflight=0))


def jax_demo_request(seed, batch, goals, T, qc, field):
    """examples/throughput_serving.py's make_request, its numpy part."""
    rng = np.random.default_rng(seed)
    tf_goal = np.stack(
        [np.stack([make_synthetic_goal(seed * goals + g) for g in range(goals)]) for _ in range(batch)]
    ).astype(np.float32)
    tf_goal[..., :3, 3] += rng.normal(scale=0.02, size=tf_goal[..., :3, 3].shape)
    qc_opt = np.tile(qc[:7], (batch, 1))
    X0 = np.tile(qc_opt[:, None, :], (1, T - 2, 1))
    params = {
        "q_param": np.tile(qc[7:], (batch, 1)),
        "tf_goal": tf_goal,
        "goal_mask": np.ones((batch, goals), bool),
        "base_position": np.zeros((batch, 3), np.float32),
        "sdf_cost_all": np.tile(field, (batch, 1)),
        "sdf_cost_obstacle": np.tile(field, (batch, 1)),
    }
    return qc_opt, X0, params


@pytest.fixture(scope="module")
def server():
    return serving.Server(iterations=ITERATIONS, goals=GOALS, device="cpu", dtype=torch.float64, points_per_link=8)


def test_make_request_equals_the_jax_demo(server):
    assert serving.make_args([]).__dict__ == {
        "batch": 16, "batches": 8, "inflight": 4, "iterations": 10, "goals": 4, "device": "cuda",
    }
    qc = SYNTH_DEFAULT_POSE.astype(np.float32)
    field = jax_field(jax_synth(points_per_link=8))
    np.testing.assert_array_equal(server.field, field)
    for seed in (0, 3):
        got = serving.make_request(seed, 5, 3, 50, qc, field)
        want = jax_demo_request(seed, 5, 3, 50, qc, field)
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert list(got[2]) == list(want[2])
        for k in want[2]:
            assert got[2][k].dtype == want[2][k].dtype, k
            np.testing.assert_array_equal(got[2][k], want[2][k])


def test_plan_stream_around_the_stacked_solve_is_the_synchronous_loop():
    server = serving.Server(iterations=2, goals=GOALS, device="cpu", dtype=torch.float64, points_per_link=8)
    requests = [server.request(seed, BATCH) for seed in range(3)]
    sync = [server.solve(*r)[:2] for r in requests]
    for depth in (2, 4):
        out = serving.serve(server, requests, depth)
        assert len(out["pipelined"]) == len(out["sync"]) == len(requests)
        assert out["retired_by_submit"] == max(0, len(requests) - depth)
        for (Q, c), (Qs, cs), (Qp, cp) in zip(sync, out["sync"], out["pipelined"]):
            for a, b in ((Qs, Q), (Qp, Q), (cs, c), (cp, c)):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert out["sync_plans_per_s"] > 0 and out["pipelined_plans_per_s"] > 0 and out["submit_ms"] >= 0
    Q, c = sync[0]
    assert tuple(Q.shape) == (BATCH, server.planner.T, 7) and bool(torch.isfinite(c).all())


def test_one_request_matches_the_jax_solve_batch(server):
    jr = jax_synth(dtype=jnp.float64, points_per_link=8)
    # the server's robot is the JAX demo's robot carried across
    carried = robot_from_numpy(jax_robot_state(jr), device="cpu", dtype=torch.float64)
    for name, pts in carried.surface_points.items():
        np.testing.assert_array_equal(server.robot.surface_points[name], pts)
    assert (carried.grid.origin, carried.grid.shape, carried.grid.resolution) == (
        server.robot.grid.origin, server.robot.grid.shape, server.robot.grid.resolution)
    for lim in ("lower_optimized_joint_limits", "upper_optimized_joint_limits", "velocity_optimized_joint_limits"):
        np.testing.assert_array_equal(getattr(server.robot, lim), getattr(carried, lim))
    solve_batch = JaxPlanner(jr, SYNTH_LINK_EE, SYNTH_LINK_GRIPPER, iterations=ITERATIONS).setup_optimization(
        goal_size=GOALS, use_standoff=True, axis_standoff="z"
    ).solve_batch
    qc = SYNTH_DEFAULT_POSE.astype(np.float32)
    qc_opt, X0, params = serving.make_request(1, BATCH, GOALS, 50, qc, server.field)

    def f64(a):
        return jnp.asarray(a) if a.dtype == bool else jnp.asarray(a, jnp.float64)

    Qj, cj, _ = solve_batch(f64(qc_opt), f64(X0), {k: f64(v) for k, v in params.items()})
    Qp, cp, _ = server.solve(*server.request(1, BATCH))
    np.testing.assert_allclose(np_(Qp), np.asarray(Qj), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np_(cp), np.asarray(cj), rtol=1e-9, atol=0)
    assert float(np.abs(np.asarray(Qj[:, -1]) - np.asarray(Qj[:, 0])).max()) > 1e-2  # the plans moved
