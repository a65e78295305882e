"""Serving-style throughput demo: a stream of planning requests drives the
goal-set solver on the card with a bounded number of batches in flight.

Port of examples/throughput_serving.py. The reference plans one object
at a time, synchronously; deployed as a service, the same work is a
request stream. Each request is a batch of goal-set problems, each with
its own cost field; a solve packs the batch's fields into one stacked
corner table (`GTOPlanner.pack_stacked_fields`, each problem's slab
selected by its `field_base`) and runs `solve_batch_stacked`, so the field
lookup (kernel K4) reads the stacked table. The demo keeps `--inflight`
solves outstanding (`parallel.PlanStream`) and reports synchronous and
pipelined plans/s.

Self-contained (the synthetic 7-DoF arm, no assets); runs on the card:

    python -m grasptrajopt_tpu_torch.throughput_serving --batches 8 --batch 16

and with `--device cpu` on the host (float32, the kernels' plain
versions). It prints one JSON line (the rates, their ratio, the host
time of a submit and the device's name), then the demo's line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from grasptrajopt_tpu_torch.convert import params_from_numpy
from grasptrajopt_tpu_torch.parallel import PlanStream
from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner
from grasptrajopt_tpu_torch.testing import (
    SYNTH_DEFAULT_POSE,
    SYNTH_LINK_EE,
    SYNTH_LINK_GRIPPER,
    make_synthetic_goal,
    make_synthetic_gto_robot,
    make_synthetic_scene_field,
)


def make_request(seed: int, batch: int, goals: int, T: int, qc: np.ndarray, field: np.ndarray):
    """One request of `batch` problems of `goals` goals, host numpy, as the
    JAX demo builds it: (qc_opt (B, 7), X0 (B, T - 2, 7), params) with
    per-problem goals jittered by 2 cm from default_rng(seed), the
    synthetic arm's default pose as the start and warm start, and every
    problem's own copy of the scene field (sdf_cost_all and
    sdf_cost_obstacle, (B, S))."""
    rng = np.random.default_rng(seed)
    tf_goal = np.stack(
        [
            np.stack([make_synthetic_goal(seed * goals + g) for g in range(goals)])
            for _ in range(batch)
        ]
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


class Server:
    """The demo's model and solver on one device: the synthetic arm at
    `points_per_link` surface points a link, `GTOPlanner(iterations=...)`
    with its other defaults, the standoff along z, and the synthetic
    tabletop field. `request(seed, batch)` builds a request on the device;
    `solve(qc_opt, X0, params)` serves it."""

    def __init__(self, iterations: int = 10, goals: int = 4, device="cuda", dtype=torch.float32,
                 points_per_link: int = 32):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available: pass --device cpu to run on the host")
        self.goals = goals
        self.robot = make_synthetic_gto_robot(device=self.device, dtype=dtype, points_per_link=points_per_link)
        self.planner = GTOPlanner(self.robot, SYNTH_LINK_EE, SYNTH_LINK_GRIPPER, iterations=iterations)
        self.solvers = self.planner.setup_optimization(goal_size=goals, use_standoff=True, axis_standoff="z")
        self.field = make_synthetic_scene_field(self.robot)
        self.qc = SYNTH_DEFAULT_POSE.astype(np.float32)

    def request(self, seed: int, batch: int):
        """make_request's arrays as tensors on the device, in the robot's
        dtype (the goal mask bool)."""
        qc_opt, X0, params = make_request(seed, batch, self.goals, self.planner.T, self.qc, self.field)
        cast = dict(device=self.device, dtype=self.robot.dtype)
        return torch.as_tensor(qc_opt, **cast), torch.as_tensor(X0, **cast), params_from_numpy(params, **cast)

    def solve(self, qc_opt, X0, params):
        """One batch: pack the per-problem fields into one stacked table
        and solve every problem against its own slab. (Q (B, T, 7),
        cost (B,), aux)."""
        tables, base = self.planner.pack_stacked_fields(params["sdf_cost_all"], params["sdf_cost_obstacle"])
        per = {k: params[k] for k in ("q_param", "tf_goal", "goal_mask", "base_position")}
        per["field_base"] = base
        return self.solvers.solve_batch_stacked(qc_opt, X0, per, {"packed_fields": tables})


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(server: Server, requests, inflight: int) -> dict:
    """The demo's measurement: one warm-up solve, the synchronous loop
    (a solve, then wait for the device), then the same requests through
    `PlanStream` at depth `inflight`. Returns the wall times, plans/s,
    the host's mean time inside `submit`, each synchronous solve's and
    each submit's time, how many results `submit` retired (the rest come
    from `drain`), and each request's (Q, cost) from both loops, in
    submission order."""
    dev = server.device
    server.solve(*requests[0])
    _sync(dev)

    sync_out, solve_s = [], []
    t0 = time.perf_counter()
    for r in requests:
        t1 = time.perf_counter()
        Q, cost, _ = server.solve(*r)
        _sync(dev)
        solve_s.append(time.perf_counter() - t1)
        sync_out.append((Q, cost))
    t_sync = time.perf_counter() - t0

    stream = PlanStream(server.solve, inflight=inflight)
    stream_out, submit_s = [], []
    t0 = time.perf_counter()
    for r in requests:
        t1 = time.perf_counter()
        done = stream.submit(*r)
        submit_s.append(time.perf_counter() - t1)
        stream_out.extend(out[:2] for out in done)
    retired_by_submit = len(stream_out)
    stream_out.extend(out[:2] for out in stream.drain())
    t_stream = time.perf_counter() - t0
    if stream.completed != len(requests) or len(stream_out) != len(requests):
        raise RuntimeError(f"the stream retired {stream.completed} of {len(requests)} requests")

    n = sum(int(r[0].shape[0]) for r in requests)
    return {
        "sync_s": t_sync,
        "pipelined_s": t_stream,
        "sync_plans_per_s": n / t_sync,
        "pipelined_plans_per_s": n / t_stream,
        "ratio": t_sync / t_stream,
        "submit_ms": 1e3 * sum(submit_s) / len(submit_s),
        "sync_solve_s": solve_s,
        "submit_s": submit_s,
        "retired_by_submit": retired_by_submit,
        "sync": sync_out,
        "pipelined": stream_out,
    }


def make_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=16, help="problems per request batch")
    p.add_argument("--batches", type=int, default=8, help="request batches to stream")
    p.add_argument("--inflight", type=int, default=4)
    p.add_argument("--iterations", type=int, default=10)
    p.add_argument("--goals", type=int, default=4)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = make_args(argv)
    server = Server(iterations=args.iterations, goals=args.goals, device=args.device)
    requests = [server.request(s, args.batch) for s in range(args.batches)]
    out = serve(server, requests, args.inflight)
    dev = server.device
    print(json.dumps({
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "batch": args.batch, "batches": args.batches, "inflight": args.inflight,
        "iterations": args.iterations, "goals": args.goals,
        **{k: out[k] for k in ("sync_plans_per_s", "pipelined_plans_per_s", "ratio", "submit_ms")},
    }))
    print(
        f"synchronous: {out['sync_plans_per_s']:7.1f} plans/s   "
        f"pipelined (inflight={args.inflight}): {out['pipelined_plans_per_s']:7.1f} plans/s   "
        f"({out['ratio']:.2f}x)"
    )


if __name__ == "__main__":
    main()
