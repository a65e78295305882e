"""Driver of the batched goal-set solve (`grasptrajopt_tpu_torch.bench`).

Set-up builds the program's `SolveBench` (the synthetic arm, the slab
field packed into K4's corner table, the IK warm start of every goal) over
the first perception of the goal sets that the benchmark draws from the
seed, then runs one solve to warm up the cell's shapes. The window drives
`SolveBench.step` back to back through the program's `stream_map` at the
traffic's in-flight depth and drains it; each solve is handed a fresh
batch of goal sets (`generate.GoalStream`: the same anchors under a new
jitter) before it is issued, and every solve's plans and costs are kept
for the check.

`SolveBench` draws its goal sets itself (`bench.synthetic_goal_sets`), so
the driver puts the benchmark's first perception in that function's place
while the bench is built, and a solve's goal sets in the bench's
parameters before it is issued.

The check (after the window, the program's state freed) works out again,
with the plain reference in float64, the solve of a sample of
`CHECK_PROBLEMS` problems drawn from the seed and spread evenly over the
window's solves, each from the program's warm start X0 (the timed path's
input) under its solve's goal sets, and the warm start itself by the
reference's own IK:

  - plan_gap_rad: the widest gap between a returned plan's joint and the
    reference's, over the sample;
  - cost_gap_rel: the widest relative gap between a returned cost and the
    reference's, over the sample;
  - warm_start_miss_share: the share of the problems whose hand, at the
    IK solution the program's warm start leads to, ends more than
    `WARM_START_TOL_M` farther from its nearest goal than at the
    reference's, among those where the reference's comes within
    `REACHED_M` of a goal. (Where several goals of a set are reached to
    rounding, which one a warm start picks is noise, and a 7-joint arm
    reaches a pose along a family of joint vectors: so neither the goal
    nor the joints are compared. Where no start of the reference's
    multistart reaches a goal, which local minimum its restarts end in
    turns on rounding: such problems are counted apart, in `notes`.)
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from contextlib import contextmanager

import numpy as np
import torch

from gtobench import generate
from gtobench.reference import slab
from gtobench.reference.goalset import GoalSetSolve, Problem
from gtobench.reference.ik import IKProblem, PointIK
from gtobench.reference.synth7 import Grid, Synth7
from gtobench.window import stream_window

UNITS = "plans"
CHECK_PROBLEMS = 2048  # problem-solves the reference works out again, over the whole window
WARM_START_TOL_M = 1e-3
REACHED_M = 1e-2  # the program's own test of a goal reached, before its multistart


@contextmanager
def _replaced(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


class Driver:
    def __init__(self, cell, seed: int, device):
        t0 = time.perf_counter()
        from grasptrajopt_tpu_torch import bench
        from grasptrajopt_tpu_torch.ops import interp
        from grasptrajopt_tpu_torch.parallel import stream_map
        from grasptrajopt_tpu_torch.testing import make_synthetic_gto_robot

        self.cfg, self.traffic, self.device, self.seed = cell.config, cell.traffic, device, seed
        cfg, tr = self.cfg, self.traffic
        self.stream_map, self.interp = stream_map, interp
        G = int(cfg["goals_per_set"])
        self.tf_goal = generate.goal_sets(tr, G, seed)  # the first perception
        self.stream = generate.GoalStream(tr, G, seed, device)
        self.batch = int(tr["batch"])
        robot = make_synthetic_gto_robot(
            device=device, dtype=torch.float32, points_per_link=cfg["points_per_link"],
            grid_resolution=cfg["grid"]["resolution"],
        )
        bench_cfg = dataclasses.replace(
            bench.SolveBenchConfig(), batch=self.batch, goal_capacity=G,
            **{k: cfg[k] for k in ("T", "iterations", "single_pass", "coarse_iterations", "coarse_stride",
                                  "final_trust", "standoff_distance", "axis_standoff", "goal_weight",
                                  "field_dtype")},
        )
        t1 = time.perf_counter()
        with _replaced(bench, "synthetic_goal_sets", lambda batch, cap: self.tf_goal):
            self.bench = bench.SolveBench(robot, bench_cfg)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        self.bench.step()  # warm-up: the cell's only shapes
        self.stream.goals(0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.setup_phases = {"program_and_robot": t1 - t0, "bench_with_ik_warm_start": t2 - t1,
                             "warm_up_solve": time.perf_counter() - t2}
        self.X0 = self.bench.X0.detach().clone()
        self.num_points = robot.num_surface_points
        self.grid_size = robot.grid.size
        self.results = []
        self.k4_launches = None
        self.notes = {}

    # -- the window ---------------------------------------------------------------

    def window(self, seconds: float):
        bench, params, issued = self.bench, self.bench.params, itertools.count()

        def solve():
            bench.params = {**params, "tf_goal": self.stream.goals(next(issued))}
            return bench.step()

        def keep(i, result):
            Q, cost, _ = result
            self.results.append((Q, cost))

        launches = self.interp.field_lookup_launches
        window = stream_window(solve, self.batch, seconds, int(self.traffic["inflight"]),
                               self.stream_map, keep=keep)
        self.k4_launches = self.interp.field_lookup_launches - launches
        return window

    def host_spans(self, window) -> list:
        """Host spans inside a call, besides its enqueue: none here."""
        return []

    def layer_record(self) -> dict:
        """What the per-layer readers need besides the trace: the K4
        launches of one solve as (points, table rows, row bases), worked
        out from the configuration, and the launches the program's own
        counter saw in the window, which the reader holds them to."""
        cfg = self.cfg
        B, T, P = self.batch, cfg["T"], self.num_points
        ppl = cfg["points_per_link"]
        p_coarse = (P // ppl) * len(range(0, ppl, cfg["coarse_stride"]))  # every stride-th point of each link
        fine = cfg["iterations"] - cfg["coarse_iterations"] + (0 if cfg["final_trust"] else 1)
        rows = 2 * self.grid_size  # the shared table: scene and target-free slab
        launches = [(B * T * p_coarse, rows, 1)] * cfg["coarse_iterations"] + [(B * T * P, rows, 1)] * fine
        return {"k4_launches_per_call": launches, "k4_launches_counted": self.k4_launches}

    def release(self):
        """Free the program's state; the kept outputs stay."""
        self.bench = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------------

    def sample(self, solves: int) -> list:
        """[(solve, problem indices)]: ceil(CHECK_PROBLEMS / solves) distinct
        problems of each solve (all of them in a small batch), drawn from
        the seed."""
        r = generate.rng(self.seed, "check")
        m = min(self.batch, math.ceil(CHECK_PROBLEMS / solves))
        return [(k, np.sort(r.choice(self.batch, size=m, replace=False))) for k in range(solves)]

    def reference(self, picks, dtype=torch.float64, tf32: bool = False) -> dict:
        """The reference's solve of the sampled problems `picks` from the
        program's warm start, and its own warm start of every problem, in
        `dtype` (with TF32 matrix products where `tf32`)."""
        cfg, dev = self.cfg, self.device
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            arm = Synth7(dev, dtype, cfg["points_per_link"])
            g = cfg["grid"]
            grid = Grid.workspace(g["arm_len"], g["arm_height"], g["margin"], g["resolution"])
            field = torch.as_tensor(slab.cost_field(cfg["slab"], grid), dtype=dtype, device=dev)
            qc = torch.as_tensor(np.asarray(cfg["start_pose"]), dtype=dtype, device=dev)
            rows = torch.as_tensor(np.concatenate([idx for _, idx in picks]), device=dev)
            tf_goal = torch.cat([self.stream.goals(k)[torch.as_tensor(idx, device=dev)] for k, idx in picks])
            tf_goal = tf_goal.to(dtype)
            S, G = tf_goal.shape[:2]
            problem = Problem.from_config(cfg)
            Q, cost = GoalSetSolve(arm, grid, problem).solve(
                qc[:7].expand(S, 7), self.X0[rows].to(dtype), qc[7:].expand(S, 2), tf_goal,
                torch.ones((S, G), dtype=torch.bool, device=dev), field,
                torch.zeros((S, 3), dtype=dtype, device=dev),
            )
            first = torch.as_tensor(self.tf_goal, dtype=dtype, device=dev)
            X0 = warm_start(arm, qc, first, problem.T - 2, IKProblem(iterations=cfg["ik_iterations"]),
                            cfg["ik_seeds"], cfg["ik_restart_seed"])
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        return {"Q": Q.double(), "cost": cost.double(), "X0": X0.double()}

    def numbers(self, results, X0, picks, ref) -> list:
        """[(name, value)]: the sampled problems `picks` of the solves'
        plans and costs `results`, and the warm start X0, against the
        reference `ref`."""
        Q = torch.cat([results[k][0][torch.as_tensor(idx, device=results[k][0].device)] for k, idx in picks])
        cost = torch.cat([results[k][1][torch.as_tensor(idx, device=results[k][1].device)] for k, idx in picks])
        plan_gap = float((Q.double() - ref["Q"]).abs().amax())
        cost_gap = float(((cost.double() - ref["cost"]).abs() / ref["cost"].abs().clamp(min=1e-12)).amax())
        reach = self.warm_start_reach(ref["X0"])
        farther = self.warm_start_reach(X0) - reach
        reached = reach < REACHED_M
        misses = float(((farther > WARM_START_TOL_M) & reached).double().mean())
        self.notes = {"reference_unreached": int((~reached).sum()),
                      "farther_where_unreached": int(((farther > WARM_START_TOL_M) & ~reached).sum())}
        return [("plan_gap_rad", plan_gap), ("cost_gap_rel", cost_gap), ("warm_start_miss_share", misses)]

    def warm_start_reach(self, X0):
        """(B,) the distance from the hand (float64 reference kinematics)
        to the nearest goal of its set, at the IK solution a warm start X0
        (B, n, 7) leads to: its last sample is the smoothstep's value at
        n / (n + 1) of the way from the start pose."""
        arm = Synth7(self.device, torch.float64, self.cfg["points_per_link"])
        qc = torch.as_tensor(np.asarray(self.cfg["start_pose"]), dtype=torch.float64, device=self.device)
        n = X0.shape[1]
        t = n / (n + 1)
        q_end = qc[:7] + (X0[:, -1].double() - qc[:7]) / (3 * t**2 - 2 * t**3)
        q = torch.cat([q_end, qc[7:].expand(q_end.shape[0], 2)], -1)
        hand = arm.link_transforms(q)["hand"][:, :3, 3]
        goals = torch.as_tensor(self.tf_goal[..., :3, 3], dtype=torch.float64, device=self.device)
        return torch.linalg.vector_norm(goals - hand[:, None], dim=-1).amin(dim=1)

    def check(self) -> list:
        picks = self.sample(len(self.results))
        return self.numbers(self.results, self.X0, picks, self.reference(picks))

    def faults(self) -> dict:
        """{fault: [(name, value)]} of faults planted in the outputs: the
        warm start left at the start pose (its IK state unchanged), for
        every problem and for half of them; the solve's plans returned
        unchanged from the warm start; and half of each solve's plans and
        costs left out, the other half's in their place."""
        picks = self.sample(len(self.results))
        ref = self.reference(picks)
        B, n, _ = self.X0.shape
        h = B // 2
        qc = torch.as_tensor(np.asarray(self.cfg["start_pose"][:7]), dtype=self.X0.dtype, device=self.device)
        half_X0 = torch.cat([self.X0[: B - h], qc.expand(h, n, 7)])
        unchanged = [(torch.cat([qc.expand(B, 2, 7), self.X0], 1), c) for _, c in self.results]
        halved = [(torch.cat([Q[: B - h], Q[:h]]), torch.cat([c[: B - h], c[:h]])) for Q, c in self.results]
        return {
            "warm_start_unchanged": self.numbers(self.results, qc.expand(B, n, 7), picks, ref),
            "warm_start_half_unchanged": self.numbers(self.results, half_X0, picks, ref),
            "solve_unchanged": self.numbers(unchanged, self.X0, picks, ref),
            "solve_half_left_out": self.numbers(halved, self.X0, picks, ref),
        }

    def control(self) -> list:
        """The numbers of the control: the reference in float32 with TF32
        matrix products (the precision below the configuration's float32
        with TF32 off) in the program's place."""
        picks = self.sample(len(self.results))
        ctl = self.reference(picks, torch.float32, tf32=True)
        ref = self.reference(picks)
        out, i = [], 0
        for k, idx in picks:  # the control's sample laid out as the window's solves
            Q = torch.zeros((self.batch,) + ctl["Q"].shape[1:], dtype=torch.float64, device=self.device)
            cost = torch.ones(self.batch, dtype=torch.float64, device=self.device)
            Q[torch.as_tensor(idx, device=self.device)] = ctl["Q"][i:i + len(idx)]
            cost[torch.as_tensor(idx, device=self.device)] = ctl["cost"][i:i + len(idx)]
            out.append((Q, cost))
            i += len(idx)
        return self.numbers(out, ctl["X0"], picks, ref)


def warm_start(arm: Synth7, qc, tf_goal, n: int, ik: IKProblem, seeds: int, restart_seed: int):
    """The IK warm start of every problem, worked out by the reference: the
    IK of every goal from the start pose; for the problems where every goal
    misses by more than 1 cm, the multistart IK (the start pose and
    seeds - 1 restarts) in its place; each problem starts from its goal of
    least position error + 2e-3 x rotation error (degrees), on the
    smoothstep from the start pose sampled at n inner points of [0, 1].
    Returns (B, n, 7)."""
    B, G = tf_goal.shape[:2]
    solver = PointIK(arm, ik)
    goals = tf_goal.reshape(B * G, 4, 4)
    qf = qc[7:].expand(B * G, 2)
    q0 = qc[:7].expand(B * G, 7)
    q, _ = solver.solve(q0, qf, goals)
    pos, rot = solver.errors(q, qf, goals)
    hard = (pos.reshape(B, G) > 0.01).all(dim=1)
    if bool(hard.any()):
        rows = hard.repeat_interleave(G)
        restarts = solver.restarts(B * G, seeds, restart_seed, torch.float32, qc.device)[rows]
        k = restarts.shape[0]
        starts = torch.cat([q0[rows][:, None], restarts], 1)  # (k, S, 7)
        S = starts.shape[1]
        qm, cm = solver.solve(starts.reshape(k * S, 7), qf[rows].repeat_interleave(S, 0),
                              goals[rows].repeat_interleave(S, 0))
        best = torch.argmin(cm.reshape(k, S), 1)
        qm = qm.reshape(k, S, 7)[torch.arange(k, device=qm.device), best]
        pm, rm = solver.errors(qm, qf[rows], goals[rows])
        q, pos, rot = q.clone(), pos.clone(), rot.clone()
        q[rows], pos[rows], rot[rows] = qm, pm, rm
    err = (pos + 2e-3 * rot).reshape(B, G)
    best = torch.argmin(err, 1)
    q_best = q.reshape(B, G, 7)[torch.arange(B, device=q.device), best]
    t = torch.linspace(0.0, 1.0, n + 2, dtype=torch.float64)[1:-1].to(q.dtype).to(q.device)
    s = 3.0 * t**2 - 2.0 * t**3
    return qc[:7] + s[None, :, None] * (q_best - qc[:7])[:, None, :]
