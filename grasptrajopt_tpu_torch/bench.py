"""The solve that the JAX package's bench.py measures, on the port.

A batch of goal-set trajectory problems in field mode against ONE scene
shared by the batch (the analytic table slab, as an eps-band cost field
packed once into a (2S, 8) corner table), each problem warm-started from
its best IK solution: the synthetic arm `synth7` (bench.py's branch
without robot data), B = 32 problems of 8 goals, T = 50, 3 single-pass LM
iterations with the coarse phase 2+1 at stride 2 and final_trust. Two
other flavours: the two-pass iteration (coarse and final_trust off) and a
long horizon (T = 200, cyclic-reduction KKT); and the default flavour with
the corner table in bf16 (the JAX bench's BENCH_BF16=1: half the bytes
of every row K4 reads, upcast to float32 after the load).

Per solve the field lookup (kernel K4) launches once per linearisation
and once per candidate pass: 3 times in the default and long-horizon
and bf16 flavours (2 coarse + 1 fine; final_trust skips the post-scan
pass), 7 in the two-pass flavour (1 + 3 x 2).

The mesh mode (bench.py's BENCH_MESH=N, `ShardedSolveBench`) gives every
problem its own copy of the field and shards the batch over N ranks, one
card each: each rank packs its shard's fields into one stacked table
inside the timed step and solves it (`solve_batch_stacked`, K4 on the
stacked table), and one all_reduce gives the global mean cost.

Run on a machine with a CUDA device (there is no CPU measurement path):

    python -m grasptrajopt_tpu_torch.bench [--flavour default|two_pass|long_horizon|bf16]
    python -m grasptrajopt_tpu_torch.bench --mesh 1         # the sharded solve, a world of one
    torchrun --nproc_per_node N -m grasptrajopt_tpu_torch.bench --mesh N

It prints one JSON line (in mesh mode rank 0 does): latency (best of
`reps` synchronized solves), sustained plans/s (`pipe_reps` solves
through `parallel.stream_map` with `INFLIGHT` = 4 solves outstanding, as
bench.py measures it), the table's `itemsize` and the corner-row bytes
K4 reads a solve (`gather_bytes`, as the JAX bench counts them), the
bench's quality gates (`quality_gates`), and in mesh mode `mesh`
("Nxcuda") and the global `mean_cost`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from grasptrajopt_tpu_torch.parallel import data_mesh, distributed_init, make_sharded_solver, shard_batch, stream_map
from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner
from grasptrajopt_tpu_torch.planning.ik_solver import IKSolver
from grasptrajopt_tpu_torch.planning.utils import interpolate_waypoints
from grasptrajopt_tpu_torch.testing import (
    SYNTH_DEFAULT_POSE,
    SYNTH_LINK_EE,
    SYNTH_LINK_GRIPPER,
    make_synthetic_goal,
    make_synthetic_gto_robot,
)

# analytic table slab (world frame): the bench scene's obstacle
SLAB_X = (0.2, 0.9)
SLAB_Y = (-0.6, 0.6)
SLAB_Z = (0.10, 0.15)


def slab_signed_distance(pts: np.ndarray) -> np.ndarray:
    """Exact signed distance to the axis-aligned table slab (negative
    inside): the standard box SDF."""
    center = np.array([np.mean(SLAB_X), np.mean(SLAB_Y), np.mean(SLAB_Z)])
    half = np.array([
        (SLAB_X[1] - SLAB_X[0]) / 2,
        (SLAB_Y[1] - SLAB_Y[0]) / 2,
        (SLAB_Z[1] - SLAB_Z[0]) / 2,
    ])
    d = np.abs(pts - center) - half
    outside = np.linalg.norm(np.maximum(d, 0.0), axis=-1)
    inside = np.minimum(np.max(d, axis=-1), 0.0)
    return outside + inside


def make_cost_field(grid, epsilon: float = 0.02) -> np.ndarray:
    """The eps-band shaped obstacle cost of the slab on the grid's corners
    (flat (S,) float32)."""
    d = slab_signed_distance(grid.grid_points().astype(np.float64))
    cost = np.zeros_like(d)
    inside = d <= 0
    band = (d > 0) & (d < epsilon)
    cost[inside] = -d[inside] + epsilon / 2
    cost[band] = np.square(d[band] - epsilon) / (2 * epsilon)
    return cost.astype(np.float32)


def make_goal_sets(RT_base: np.ndarray, batch: int, cap: int, rng) -> np.ndarray:
    """Diverse reachable goal sets for a robot with data: per problem a
    position offset over the table and a base yaw; per goal slot a further
    yaw about world z plus small positional jitter. (batch, cap, 4, 4)
    float32."""
    RT = RT_base.copy()
    RT[2, 3] += 0.08  # fingertips clear the slab top by more than the eps band
    tf_goal = np.tile(RT, (batch, cap, 1, 1)).astype(np.float32)
    d_pos = np.stack(
        [
            rng.uniform(-0.08, 0.08, size=(batch,)),
            rng.uniform(-0.15, 0.15, size=(batch,)),
            rng.uniform(0.0, 0.08, size=(batch,)),
        ],
        axis=-1,
    )
    base_yaw = rng.uniform(-np.pi, np.pi, size=(batch,))
    for b in range(batch):
        for g in range(cap):
            yaw = base_yaw[b] + g * (2 * np.pi / cap)
            c, s = np.cos(yaw), np.sin(yaw)
            Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            tf_goal[b, g, :3, :3] = Rz @ tf_goal[b, g, :3, :3]
            tf_goal[b, g, :3, 3] += d_pos[b] + rng.normal(scale=0.005, size=3)
    return tf_goal


def synthetic_goal_sets(batch: int, cap: int) -> np.ndarray:
    """The synthetic arm's goal sets: one reachable grasp jittered by 2 cm
    per goal slot, from default_rng(0). (batch, cap, 4, 4) float32."""
    rng = np.random.default_rng(0)
    tf_goal = np.tile(make_synthetic_goal(0).astype(np.float32), (batch, cap, 1, 1))
    tf_goal[..., :3, 3] += rng.normal(scale=0.02, size=(batch, cap, 3)).astype(np.float32)
    return tf_goal


@dataclass(frozen=True)
class SolveBenchConfig:
    """bench.py's defaults for an arm of the panda's flavour."""

    batch: int = 32
    goal_capacity: int = 8
    T: int = 50
    iterations: int = 3
    single_pass: bool = True
    coarse_iterations: int = 2
    coarse_stride: int = 2
    final_trust: bool = True
    cyclic_reduction: bool = False
    standoff_distance: float = -0.1
    axis_standoff: str = "z"
    goal_weight: float = 1.0
    goal_coherence: float = 0.0
    field_dtype: str = "float32"  # the corner table's dtype: "float32" or "bfloat16"
    reps: int = 2  # synchronized solves; the best is the latency
    pipe_reps: Optional[int] = None  # solves of the sustained rate (None: max(reps, 5), as bench.py)


INFLIGHT = 4  # solves outstanding while the sustained rate is measured (bench.py's depth)


FLAVOURS = {
    "default": SolveBenchConfig(),
    # BENCH_1PASS=0: the coarse phase and final_trust are single-pass only
    "two_pass": SolveBenchConfig(single_pass=False, coarse_iterations=0, final_trust=False),
    # BENCH_T=200 BENCH_CR=1
    "long_horizon": SolveBenchConfig(T=200, cyclic_reduction=True),
    # BENCH_BF16=1
    "bf16": SolveBenchConfig(field_dtype="bfloat16"),
}


def warm_start(robot, ik: IKSolver, qc, tf_goal, T: int, seed: int = 0, restarts=None):
    """bench.py's IK warm start: a single-seed IK screen over every goal;
    for the problems where every goal misses by more than 1 cm, the
    multistart IK (restarts from `seed`, or the given `restarts`
    (B * cap, num_seeds - 1, n_opt)) replaces that problem's solutions;
    each problem starts from its goal of least err_pos + 2e-3 err_rot,
    interpolated from qc to T samples. qc (ndof,); tf_goal (B, cap, 4, 4).
    Returns (X0 (B, T, n_opt), warm_goal (B,))."""
    B, cap = tf_goal.shape[:2]
    goals = tf_goal.reshape(B * cap, 4, 4)
    qsol, pos, rot, _ = ik.solve_ik_batch(qc, goals)
    err = (pos + 2e-3 * rot).reshape(B, cap)
    hard = (pos.reshape(B, cap) > 0.01).all(dim=1)
    if bool(hard.any()):
        qsol_m, pos_m, rot_m, _ = ik.solve_ik_batch(qc, goals, multistart=True, seed=seed, restarts=restarts)
        err = torch.where(hard[:, None], (pos_m + 2e-3 * rot_m).reshape(B, cap), err)
        qsol = torch.where(hard.repeat_interleave(cap)[:, None], qsol_m, qsol)
    warm_goal = torch.argmin(err, dim=1)
    q_best = qsol.reshape(B, cap, -1)[torch.arange(B, device=qsol.device), warm_goal]
    X0 = robot.extract_optimized_dimensions(interpolate_waypoints(qc, q_best, T))
    return X0, warm_goal


def _rotation_angle_deg(Ra, Rb):
    """Angle (degrees) of the relative rotation Ra^T Rb, (..., 3, 3)."""
    tr = np.einsum("...ji,...ji->...", Ra, Rb)
    return np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))


def quality_gates(T_end, tf_goal, body_points):
    """bench.py's plan-quality gates, host numpy: T_end (B, 4, 4) final
    end-effector poses; tf_goal (B, cap, 4, 4) goals; body_points
    (B, T, P, 3) the plans' body surface points, all in the world frame.

    A plan reaches when some goal is within 1 cm and 5 degrees; it
    collides when some step has more than 5 body points inside the slab.
    err_pos / err_rot are at each plan's goal of least d + 2e-3 rot."""
    d = np.linalg.norm(tf_goal[:, :, :3, 3] - T_end[:, None, :3, 3], axis=-1)  # (B, cap)
    rot = _rotation_angle_deg(tf_goal[..., :3, :3], T_end[:, None, :3, :3])
    B = d.shape[0]
    best = np.argmin(d + rot * 2e-3, axis=1)
    err_pos, err_rot = d[np.arange(B), best], rot[np.arange(B), best]
    p = body_points
    inside = (
        (p[..., 0] > SLAB_X[0]) & (p[..., 0] < SLAB_X[1])
        & (p[..., 1] > SLAB_Y[0]) & (p[..., 1] < SLAB_Y[1])
        & (p[..., 2] > SLAB_Z[0]) & (p[..., 2] < SLAB_Z[1])
    )
    counts = inside.sum(axis=-1)  # (B, T)
    return {
        "reached_frac": float(((d < 0.01) & (rot < 5.0)).any(axis=1).mean()),
        "collision_frac": float((counts > 5).any(axis=-1).mean()),
        "err_pos_median": float(np.median(err_pos)),
        "err_pos_p90": float(np.quantile(err_pos, 0.9)),
        "err_rot_median_deg": float(np.median(err_rot)),
        "max_inside_points": int(counts.max()),
    }


class SolveBench:
    """The bench problem on the robot's device: goal sets, the shared
    packed slab field, the IK warm start (untimed set-up) and `step`, one
    batched solve through `solve_batch_shared`."""

    def __init__(self, robot, cfg: SolveBenchConfig = SolveBenchConfig()):
        self.robot, self.cfg = robot, cfg
        dev, dt = robot.device, robot.dtype
        field_dtype = getattr(torch, cfg.field_dtype)
        self.planner = GTOPlanner(
            robot, SYNTH_LINK_EE, SYNTH_LINK_GRIPPER, iterations=cfg.iterations,
            standoff_distance=cfg.standoff_distance, single_pass=cfg.single_pass,
            cyclic_reduction=cfg.cyclic_reduction, goal_weight=cfg.goal_weight, T=cfg.T,
            coarse_iterations=cfg.coarse_iterations, coarse_stride=cfg.coarse_stride,
            final_trust=cfg.final_trust, goal_coherence=cfg.goal_coherence,
            field_dtype=None if field_dtype == torch.float32 else field_dtype,
        )
        self.solvers = self.planner.setup_optimization(
            goal_size=cfg.goal_capacity, use_standoff=True, axis_standoff=cfg.axis_standoff
        )
        self.ik = IKSolver(robot, SYNTH_LINK_EE, SYNTH_LINK_GRIPPER, collision_avoidance=False)
        B = cfg.batch
        self.qc = torch.as_tensor(SYNTH_DEFAULT_POSE, dtype=dt, device=dev)
        self.tf_goal = torch.as_tensor(synthetic_goal_sets(B, cfg.goal_capacity), dtype=dt, device=dev)
        self.field = torch.as_tensor(make_cost_field(robot.grid), dtype=dt, device=dev)
        packed = robot.grid.pack(self.field, self.planner.field_dtype)
        # one shared table: the scene field and the target-free field, here both the slab's
        self.table = torch.cat([packed, packed], dim=0)
        self.X0, self.warm_goal = warm_start(robot, self.ik, self.qc, self.tf_goal, cfg.T - 2)
        self.qc_opt = robot.extract_optimized_dimensions(self.qc).expand(B, -1)
        self.q_param = robot.extract_parameter_dimensions(self.qc).expand(B, -1)
        self.params = {
            "q_param": self.q_param,
            "tf_goal": self.tf_goal,
            "goal_mask": torch.ones((B, cfg.goal_capacity), dtype=torch.bool, device=dev),
            "base_position": torch.zeros((B, 3), dtype=dt, device=dev),
        }
        if cfg.goal_coherence > 0:
            self.params["goal_seed"] = self.warm_goal

    def step(self):
        """One batched solve: (Q (B, T, n_opt), cost (B,), aux)."""
        return self.solvers.solve_batch_shared(
            self.qc_opt, self.X0, self.params, {"packed_fields": self.table}
        )

    def gather_bytes(self) -> int:
        """Corner-row bytes K4 reads in one solve (the JAX bench's
        gather_bytes): one row per (problem, step, surface point) of each
        pass, the coarse passes at the stride subsample, the post-scan pass
        unless final_trust skips it."""
        cfg = self.cfg
        P = self.robot.num_surface_points
        p_coarse = -(-P // cfg.coarse_stride)
        full_passes = (cfg.iterations - cfg.coarse_iterations) + (0 if cfg.final_trust else 1)
        rows = cfg.batch * cfg.T * (cfg.coarse_iterations * p_coarse + full_passes * P)
        return rows * 8 * self.table.element_size()

    def full_q(self, Q):
        return self.robot.assemble_q(Q, self.q_param[:, None, :])

    def gates(self, Q):
        """quality_gates of the plans Q (B, T, n_opt)."""
        Q_full = self.full_q(Q)
        T_end = self.robot.get_global_link_transform(SYNTH_LINK_EE, Q_full[:, -1])
        pts = self.robot.fk_surface_points(Q_full)
        return quality_gates(
            T_end.double().cpu().numpy(), self.tf_goal.double().cpu().numpy(), pts.double().cpu().numpy()
        )


class ShardedSolveBench(SolveBench):
    """bench.py's mesh mode (BENCH_MESH=N): the same problems, but every
    problem carries its own copy of the slab field (bench.py's
    `shared_scene = False`), and the batch is sharded over the ranks of
    `mesh`, one device each. `step` is the sharded solver
    (`parallel.make_sharded_solver`) around each rank's solve of its
    shard: its fields packed into one stacked corner table
    (`GTOPlanner.pack_stacked_fields`, each problem's slab picked by its
    `field_base`) and `solve_batch_stacked`. Every rank returns its own
    shard's (Q, cost, aux); `metrics` holds the last step's global
    mean cost."""

    def __init__(self, robot, cfg: SolveBenchConfig, mesh):
        super().__init__(robot, cfg)
        self.mesh = mesh
        fields = self.field.expand(cfg.batch, -1)  # (B, S): one field a problem
        self.local = shard_batch((self.qc_opt, self.X0, self.params, fields, fields), mesh)
        planner, solvers = self.planner, self.solvers

        def solve_shard(qc_opt, X0, params, sdf_cost_all, sdf_cost_obstacle):
            tables, base = planner.pack_stacked_fields(sdf_cost_all, sdf_cost_obstacle)
            return solvers.solve_batch_stacked(
                qc_opt, X0, {**params, "field_base": base}, {"packed_fields": tables}
            )

        self.solve_shard = solve_shard
        self.sharded = make_sharded_solver(solve_shard, mesh)
        self.metrics = None

    def step(self):
        """One sharded solve: this rank's (Q (B / n, T, n_opt), cost, aux)."""
        out, self.metrics = self.sharded(*self.local)
        return out

    def gates(self, Q):
        """quality_gates of every rank's plans: the shards gathered in rank
        order."""
        shards = [torch.empty_like(Q) for _ in range(self.mesh.size())]
        dist.all_gather(shards, Q.contiguous(), group=self.mesh.get_group())
        return super().gates(torch.cat(shards))


def stream_solves(bench: SolveBench, solves: int, inflight: int = INFLIGHT):
    """Sustained plans/s of `solves` solves through `stream_map` with
    `inflight` outstanding, as bench.py measures it; returns it with the
    last solve's (Q, cost)."""
    t0 = time.perf_counter()
    for Q, cost, _ in stream_map(lambda: bench.step(), [()] * solves, inflight=inflight):
        pass
    return solves * bench.cfg.batch / (time.perf_counter() - t0), Q, cost


def time_solves(bench: SolveBench, reps: int, pipe_reps: Optional[int] = None, inflight: int = INFLIGHT):
    """Latency (s, best of `reps` synchronized solves) and sustained
    plans/s (`stream_solves` over `pipe_reps` solves, default
    max(reps, 5), as bench.py), after one warm-up solve; returns them with
    the last solve's (Q, cost)."""
    dev = bench.robot.device
    if pipe_reps is None:
        pipe_reps = max(reps, 5)
    Q, cost, _ = bench.step()
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        Q, cost, _ = bench.step()
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    plans_per_s, Q, cost = stream_solves(bench, pipe_reps, inflight)
    return {
        "latency_s": min(times),
        "latency_runs_s": times,
        "plans_per_s": plans_per_s,
        "pipe_reps": pipe_reps,
        "inflight": inflight,
        "Q": Q,
        "cost": cost,
    }


def run(cfg: SolveBenchConfig = SolveBenchConfig(), device="cuda", mesh=None) -> dict:
    """The bench on one CUDA device: set-up, timing and gates. With `mesh`
    (`parallel.data_mesh`) the sharded solve of bench.py's mesh mode
    (`ShardedSolveBench`) on this rank's device; the result gains "mesh"
    ("<n>xcuda") and the global mean cost."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the solve bench measures a CUDA device; none is available")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    robot = make_synthetic_gto_robot(device=dev, dtype=torch.float32, points_per_link=100)
    t0 = time.perf_counter()
    bench = SolveBench(robot, cfg) if mesh is None else ShardedSolveBench(robot, cfg, mesh)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    timed = time_solves(bench, cfg.reps, cfg.pipe_reps)
    out = {
        "config": dataclasses.asdict(cfg),
        "device": torch.cuda.get_device_name(dev),
        "surface_points": robot.num_surface_points,
        "field_size": robot.grid.size,
        "setup_s": setup_s,
        "latency_s": timed["latency_s"],
        "latency_runs_s": timed["latency_runs_s"],
        "plans_per_s": timed["plans_per_s"],
        "pipe_reps": timed["pipe_reps"],
        "inflight": timed["inflight"],
        "itemsize": bench.table.element_size(),
        "gather_bytes": bench.gather_bytes(),
        "quality": bench.gates(timed["Q"]),
    }
    if mesh is not None:
        out["mesh"] = f"{mesh.size()}x{mesh.device_type}"
        out["mean_cost"] = float(bench.metrics["mean_cost"])
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--flavour", choices=sorted(FLAVOURS), default="default")
    ap.add_argument("--reps", type=int, default=None)
    ap.add_argument("--pipe-reps", type=int, default=None)
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="bench.py's BENCH_MESH=N: every problem with its own field, the batch sharded over N "
                         "ranks of one card each (N > 1 under torchrun --nproc_per_node N); rank 0 prints")
    args = ap.parse_args()
    cfg = FLAVOURS[args.flavour]
    if args.reps is not None:
        cfg = dataclasses.replace(cfg, reps=args.reps)
    if args.pipe_reps is not None:
        cfg = dataclasses.replace(cfg, pipe_reps=args.pipe_reps)
    if not args.mesh:
        print(json.dumps({"flavour": args.flavour, **run(cfg)}))
        return
    with tempfile.TemporaryDirectory() as tmp:
        # torchrun's environment names the cluster; a process alone is a world of one
        if not distributed_init(device="cuda"):
            distributed_init(coordinator=f"file://{tmp}/store", device="cuda")
        try:
            out = run(cfg, mesh=data_mesh(args.mesh))
            if dist.get_rank() == 0:
                print(json.dumps({"flavour": args.flavour, **out}))
        finally:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
