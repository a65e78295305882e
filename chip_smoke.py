#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (grasptrajopt_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

  1. device: a CUDA device is required (there is no CPU path); prints the
     card's name and power limit as nvidia-smi reports them;
  2. build: compiles the kernels (csrc/min_d2.cu: K1; csrc/nearest.cu: K2
     and K3; csrc/field_lookup.cu: K4; csrc/block_tridiag.cu: K5) with
     nvcc for sm_90a from the
     sources in this checkout, one nvcc per source, all started together,
     and prints nvcc's register and shared-memory report; beside them the
     host geometry library (csrc/geomcore.cpp) with g++;
  3. kernel vs plain: K1 against its plain-torch version on the same CUDA
     tensors, at the perception-to-plan path's widths (B = 16 clouds,
     M = 95,760 workspace grid points, N = 12,288 obstacle and 2,048 target
     points, and the pre-filter's 9,600 per-object queries: 32 grasps x
     the gripper model's 300 points), at the closed-loop pipeline's B = 1
     launches (the 95,760-cell field build, one plan's 50,000-point replay
     and the grasp filter's 9,600 points against a 25,600-pixel cloud, a
     replay against two fused views, the shelf's 766,080-cell field build
     against 14,336 points) and at ragged sizes with all-invalid clouds;
     fails above 1e-5 m^2 (squared distances here are below ~10 m^2, and
     fused multiply-adds move a value by a few float32 ulp, ~1e-6), and
     where a forced cluster size S = 1, 2, 4 or 8 differs by one bit from
     the launch plan's output at a B = 1 shape; median CUDA-event times of
     lone calls of both (with the wrapper's host time beside the kernel's),
     and at the B = 1 shapes the device time a call with the launches
     queued, the plan and S = 1 in turns; each against its bound at 7 FP32
     instructions a pair;
  4. K2 / K3 vs plain: the nearest-point kernel against its plain-torch
     version on the same CUDA tensors, at the exact per-goal tier's passes
     (C = 16 objects, M = 1.6 M body points each, N = 4,096 obstacle and
     1,024 target points), at the JAX pipeline's one-object call (C = 1),
     at ragged sizes, on a set that is all PAD_COORD rows, in the
     index-only mode (K3) under a mask with an all-invalid set, and on
     exact duplicate points, where the first index must win, and at the
     mobile occupancy builds' shapes (C = 1, 2,867 x 6,438 and 211,176 x
     11,155, cells and points in a plane, shared queries). d2 within
     1e-5 m^2 below 10 m^2 and 1e-6 relative above; the kernel's index
     points at a valid row whose float64 distance is as near (same
     tolerance) as the plain minimum's, so a near-tie the fused
     multiply-adds break the other way passes; the returned point and
     normal are that row's, bit for bit. Every case again at each forced
     cluster size S = 1, 2, 4, 8 (and 16 where the card admits it), bit
     for bit against the launch plan's output. At the exact tier's
     passes, the one-object call and the occupancy shapes: the device
     time of a call on pre-packed rows with the launches queued back to
     back, the plan and S = 1 in turns (at the occupancy shapes the
     path's min_sqdist, packing included, beside it), and the plain
     version's time, each against the bound at 7 FP32 instructions a
     pair;
  5. slice: the perception-to-plan path of bench_e2e.py (e2e.PerceptionToPlan:
     16 objects of the synthetic tabletop scenes 10/36/48/65 at 160x160, 32
     grasps each, the synthetic 7-DoF arm with 1,000 surface points on its
     95,760-cell grid; the multistart IK screen, 8 seeds x 24 iterations;
     the warm start ranked at strides (4, 4); plan T = 50 with 3
     iterations, coarse 2+1, final_trust; the rescue of the worst object
     goal by goal), once to warm up and once counted: K1 must launch
     exactly 3 times (two field passes and the grasp pre-filter) and K4 6
     times (the plan's and the rescue's coarse, coarse and fine
     linearisations), both fields and the pre-filter must agree with the
     plain version on the clouds the card produced, the plans before and
     after the rescue must be finite, within the joint limits and pinned
     at their first two steps, and K4 must agree with its plain version at
     the final plans' body points as the planner passes them (the x / y /
     z views of one (B, T, P, 3) tensor, the per-object row bases of the
     stacked table) at the fine and the coarse stride; ms per object for
     each phase (fields, IK screen, ranking, plan, rescue), the rescues
     applied and the gates (reach under the IK and the plan gates, the
     replay collision against each object's obstacle cloud: K1 exactly
     once an object), reported;
     then the IK screen with its collision term at the same shape (512
     goals x 8 seeds against the first object's obstacle field, one
     table): K4 exactly 1 + 2 x 24 = 49 launches and no other kernel, K4
     against plain at the solutions' body points, and the screen with the
     plain lookup in K4's place, timed in turns, its col_cost reported
     beside the kernel run's;
  6. per-goal tiers: for every object its kept and found grasps (all 32
     where none survives), one single-goal problem each (512 in all): the
     exact tier (points mode, 12 iterations, obstacle weight 40, against
     each object's 4,096 / 1,024-point scene sets) and the rescue tier
     (field mode at the plan's flavor), once to warm up and once counted:
     K2 must launch exactly 2 x (12 + 1) = 26 times (two point sets per
     pass) and K3 once (the tiers' clearance), K4 never in the exact tier
     and 3 times in the rescue tier, the plans of both tiers
     must be finite, within the joint limits and pinned at their first two
     steps, the exact tier's final obstacle distances must agree with
     the plain K2's, and the rescue tier's final fields with the plain
     K4's in the layout and with the per-problem row bases of its
     launches, at (512, 50, 1000) and (512, 50, 500) body points. Both
     tiers run over every object (a throughput measure; the closed loop
     of phase 8 runs them only where the replay scorer asks); the replay
     scorer's verdicts on the tiers' plans beside their clearance are
     reported;
  7. bench solve (grasptrajopt_tpu_torch.bench, the solve the JAX
     package's bench.py measures): 32 problems of 8 goals against one
     shared slab field, the synthetic arm's 1,000 body points, IK warm
     starts with the multistart rescue. First K5 against its plain loop
     on the same CUDA tensors at the KKT shapes of the cell, the serving
     path and the bench default ((2,048 | 512 | 32, 48, 7), float32, the
     solver's expanded -w I), within 1e-4 of the plain loop's largest |x|,
     one launch a call, its device time queued, the plain loop's device
     ops and time and a lone call's, and its bound by bytes and by the
     serial chain. Then K4 against its plain version
     on the same CUDA tensors: the bench's fine and coarse passes (1.6 M
     and 0.8 M body points of the warm starts) both as the AoS views the
     Jacobian pass gives (every launch of the default solve) and as the
     SoA tensors of the two-pass value passes, the slice's stacked table
     (16 objects, 98 MB), the TPU probe's shape (145,152 rows, 1.92 M
     points in the cells its uniform and coherent +-64 offsets name), and
     ragged, outside, on-face and strided (AoS) points, and K4's bf16 mode
     at the bench's fine and coarse passes (AoS and SoA) and on the
     stacked table cast to bf16; each output within 1e-5 x (1 + |plain|),
     zero gradient outside the grid; the median
     device time a call of the kernel, the plain version and the two
     library gathers of the same rows (torch.index_select and table[rows];
     the faster is the yardstick), each call's launches queued back to
     back (`queued_ms`). A report of the IK warm start (single seed and
     multistart reach on the bench's goals). Then each flavour, warmed up,
     timed (latency: best of BENCH_REPS = 2 synchronized solves; sustained
     plans/s: BENCH_PIPE_REPS = 4 solves through parallel.stream_map with
     4 in flight, as bench.py measures it) and counted once; the default
     flavour's sustained rate also at inflight 1 and 4 alternated over
     DEPTH_ROUNDS = 2 rounds (1, 4 | 4, 1) of DEPTH_SOLVES = 4 solves
     each, with each depth's spread and the host
     syncs of one solve: K4 exactly 3
     launches a solve in the
     default flavour (T = 50, single pass, coarse 2+1, final_trust), 7 in
     the two-pass flavour (1 + 3 x 2), 3 in the long-horizon flavour
     (T = 200, cyclic reduction) and 3 in the bf16 flavour (the default
     with a bf16 table, the JAX bench's BENCH_BF16), K1-K3 none, K5 once
     an iteration (3) but in the long horizon (0); the plans
     finite, within the
     limits, pinned, their final field values equal to plain K4's at the
     AoS views of their body points (fine and, with a coarse phase, coarse
     stride); the
     quality gates reported, not gated; cyclic reduction against K5 and
     against the plain Thomas loop at (32, 198, 7, 7) to 1e-4 relative;
  8. closed loop (grasptrajopt_tpu_torch.synthetic_eval, the harness a
     user runs): the synthetic arm and its gripper, one object a trial at
     full width (160x160, 32 grasps, 1,000 body points, the bench's
     planner flavour): a warm-up trial, then tabletop scene 10 (nearest
     first, its first CLOSED_LOOP_TABLETOP = 3 objects) and shelf scene 10
     (random order, 3 objects, two
     fused views, the planning fields from the first on a 2.5 cm grid
     from a 1 cm dedup). Per trial the tiers that ran (goal-set plan,
     rescue, deep, exact) and exact launch counts: K1 = 2 field builds +
     1 grasp filter + 1 per replay scoring (the pipeline's and the
     harness's; a fused cloud is one launch), K4 = 3 per goal-set plan
     and per rescue + 13 per deep tier, K2 = 26 per exact tier, K3 none;
     every plan finite, within the limits and pinned; every solve of
     every trial against the plain kernel on the tensors the solver got:
     K4 at the final plans' body points on the goal-set plan's shared
     table and the rescue's and deep tier's one-object stacked table
     (C = 1, G = 32, its row bases), fine and coarse stride, on the 5 cm
     and the shelf's 2.5 cm grid, and K2 for an exact tier; the result
     files round-trip through aggregate_results; K1 at the last tabletop
     and the last shelf trial's B = 1 launches (the two fields, 95,760 x
     25,600 and 766,080 x the downsampled first view; the filter; each
     replay, on the shelf over both views fused) against plain at
     FIELD_TOL with identical inside verdicts, and timed at every distinct
     one of those launch shapes against its bound; the exact tier on
     the last shelf trial's observation, goals and IK solutions through
     the pipeline's own tier method (the gates ask for it only after a
     colliding rescue): K2 = 26 launches and no other kernel, its plans
     checked, K2 against plain at their final body points on the scene set
     it planned against; the deep tier likewise (K4 = 13, on the shelf's
     table); one failing trial again under torch.profiler.
     Trial lines, tiers, launches and the aggregate are printed, not gated;
  9. mobile (grasptrajopt_tpu_torch.synthetic_eval_mobile, the mobile
     harness a user runs): the synthetic arm and its gripper at full width
     (the closed loop's flavour), tabletop scene 10 (nearest first, 3
     objects) and shelf scene 10 (random order, 2 objects), each a base
     placement from (-0.8, 0.3, yaw -0.3) on synth7's mount: the
     occupancy build must launch K3 exactly once and nothing else, its
     grid identical cell for cell to the plain version's on the same CUDA
     tensors and d2 within 1e-5 m^2; the solved base pose finite with
     theta in [-pi, pi]; then one trial an object in the new base frame
     with phase 8's checks (exact launch counts, plans finite, within the
     limits and pinned, each solve against the plain kernel). The tries
     and their col_cost, the base pose, the chosen grasps' errors, one
     base solve's wall time under torch.profiler, K3 at each occupancy
     shape on the build's own tensors (as phase 4 times it) and the
     trials' outcomes are printed, not gated;
 10. builder (grasptrajopt_tpu_torch.opt: the DSL, the AL-SQP, ADMM and
     SciPy solvers; models/dynamics; fields/sdf_program), no kernel on
     its path: planar IK (planar_ik.solve: the LM solve on the card and
     SLSQP, both within 1e-4 of the target); the grasp trajectory NLP
     through the DSL at full width (testing.make_dsl_trajectory_problem:
     synth7 at 100 points per link, T = 50, 693 decision variables,
     Euler coupling, initial state, joint limits; goal point-match and
     standoff, trilinear field and velocity costs on
     make_synthetic_scene_field; float64), held to the JAX package's
     full-scale builder test: (a) the DSL cost at the structured
     GTOPlanner(iterations=80) solution equals that solver's cost to 1e-6
     relative (the structured solve in float64, its field looked up by
     K4's plain version: K4 takes float32 only), (b) ALSQPSolver at 8 x 12
     iterations: violation below 1e-4 with no named violation above it,
     cost at most 1.05 x the structured one, the start within 1e-4 of qc,
     the joint limits within 1e-6; the solve runs with every launch count
     at 0 and must launch no kernel; its wall time, device time and ops
     (torch.profiler, a second solve, checked too), busy share and peak
     memory are printed; the SDF program's value and gradient against K4
     on 131,072 float32 points (LOOKUP_TOL), its Hessian symmetric with
     zero pure second derivatives; 16 equality-constrained QPs of 256
     variables through batched ADMM against their KKT solves (1e-4); the
     double pendulum's rnea against M qdd + C + g (1e-10);
 11. serving and execution (grasptrajopt_tpu_torch.throughput_serving,
     parallel, planning/retiming, envs, utils/profiling, native): the
     serving demo at its defaults (8 requests of 16 problems x 4 goals,
     each problem with its own field, packed per solve into one stacked
     table; synth7 at 32 points per link; GTOPlanner(iterations=10), the
     two-pass LM), a warm-up, the synchronous loop and the same requests
     through PlanStream at inflight 4, whose submit must retire 4 of the
     8 results at the depth bound: K4 exactly 1 + 2 x 10 = 21 launches a
     solve and K1-K3 none, every request's pipelined (Q, cost)
     bit-identical to the synchronous ones, every plan finite, within the
     limits and pinned, K4 against plain at the last request's final body
     points on its stacked table at strides 1 and 2 (LOOKUP_TOL);
     synchronous and pipelined plans/s, their ratio, each synchronous
     solve's and each submit's host time; the host syncs of one served
     solve (torch.cuda.set_sync_debug_mode) under torch.profiler's device
     activity: its device time, device ops (K4 exactly 21) and busy
     share; one served solve of a one-iteration server traced by
     utils.profiling.trace into logs/serving/trace (the file must name
     K4's kernel); 4 served plans retimed
     (convert_plan_to_trajectory: endpoints within 1e-3 rad, |qd| within
     1.05 x synth7's velocity limits) and the first executed on the
     port's fake PyBullet through FixedBaseRobot with synth7's URDF, its
     end-effector within 1e-5 m of the card's FK of the plan's last step;
     the native geometry library built (g++) and a 160x160 observation
     rendered bit-identically through it and the numpy rasterizer; the
     phase's PhaseTimer(sync=True) report;
 12. sharded solve (parallel.{mesh,sharded}, bench.ShardedSolveBench:
     bench.py's BENCH_MESH mode): a world of one on NCCL through
     distributed_init (a file:// store in a temporary directory), the
     full-width default flavour with every problem its own field (32
     slabs packed into one 196 MB stacked table inside each step):
     the step's Q and cost bit-identical to the unsharded
     solve_batch_stacked of the same problems and tables, mean_cost
     within 1e-6 relative of cost.mean(), K4 exactly 3 launches a step
     and K1-K3 none, the plans finite, within the limits and pinned, K4
     against plain at their final body points on the stacked table, no
     host sync in one step; latency, plans/s, the unsharded step's wall
     time in turns, the gates, one step's device time, ops and busy
     share, and K4 on the stacked table (queued, against plain,
     index_select and its bound);
 13. the SceneReplica drivers (grasptrajopt_tpu_torch.gto_planning,
     .evaluate_plans, .ik_checking: the ports of examples/gto_planning.py,
     evaluate_plans.py and ik_checking.py) through their main(argv) on the
     port's fake PyBullet over a synth7 tree (testing.make_scenereplica_tree:
     32 grasps an object, tabletop scene 10 and a shelf scene of 2 objects)
     at full width: synth7 at 100 points a link with its gripper, the
     env's 640x480 window, goal capacity 64, the planner's 50 two-pass
     iterations and the IK screen's 8 seeds x 50; gto_planning on the
     tabletop (both orderings) and the shelf, evaluate_plans on each result
     file, ik_checking on the tabletop. The result files in the JAX schema
     with at least 2 tabletop objects planned, every plan finite, within
     the limits and starting at the executed qc; K1 exactly 3 launches an
     object that reaches the pre-filter and 1 a replayed plan (1 an object
     in ik_checking), K4 exactly 1 + 2 x 50 a plan, K2 / K3 none; K1
     against plain at the first object's three launches, K4 against plain
     at a final plan's body points. ms an object for checking, IK and
     planning, grasps kept, IK found, rewards, the replay's verdicts, and
     one plan profiled in the run (device time, ops, host syncs; busy over
     its unprofiled twin's wall) are printed, not gated;
 14. result: the nvidia-smi line, one JSON line of kernel records (with
     each kernel's roofline bound and, for K4 in each mode, the library
     call's time; K2 / K3's times queued, K3 also at the occupancy
     builds; K4's launches are the bench solve's, a served solve's are
     printed before; K4 on the sharded step's stacked tables; K5 at the
     cell's KKT shape, its launches a bench solve's), and the last line
     {"ok": true, "device": {...}}.

No solve of phases 5, 7, 11 and 12 may synchronize the host
(torch.cuda.set_sync_debug_mode, `host_syncs`): the IK collision screen,
one bench solve of each flavour, one served solve and one sharded step;
phases 8 and 9 report the syncs of one closed-loop trial and one base
solve (their host API's inputs and results, and the pipeline's
decisions).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

FIELD_TOL = 1e-5  # m^2 for K1's d2, cost units for the shaped fields
NEAR_TOL = 1e-5  # m^2 for K2 / K3's d2 below 10 m^2 ...
NEAR_RTOL = 1e-6  # ... and relative above it (PAD_COORD rows: ~3e12 m^2)
LOOKUP_TOL = 1e-5  # K4: |err| <= LOOKUP_TOL * (1 + |plain|), value and gradients
CR_RTOL = 1e-4  # cyclic reduction against the Thomas solve, float32 on the card
K5_RTOL = 1e-4  # K5 against the plain loop in float32, relative to the largest |x|
KERNEL_SOURCES = ("min_d2", "nearest", "field_lookup", "block_tridiag")
# the H100 SXM's peaks (NVIDIA's data sheet, at 700 W): device memory, and the
# FP32 rate of 67 TFLOP/s as lane instructions (a fused multiply-add, 2
# flops, issues once)
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 3.35e13
# the least the distance-and-min work of K1, K2 and K3 needs a (query,
# point) pair: three subtracts, three multiply(-add)s (the penalty the
# first one's addend) and the min
INSTR_PER_PAIR = 7
# K5's serial chain: the H100 SXM's top SM clock (1,980 MHz) and the
# latency of one dependent FP32 fused multiply-add, 4 cycles
SM_CLOCK_HZ = 1.98e9
DEP_CYCLES = 4
# K5 at the KKT shapes (B, F, n) of the cell (2,048 problems a solve), the
# serving path (512) and the bench default (32)
K5_SHAPES = ((2_048, 48, 7), (512, 48, 7), (32, 48, 7))


def bound_ms(nbytes: float, instructions: float):
    """(ms, "bytes" or "operations"): the least time the card could take
    for work that moves `nbytes` (each input read once, each output written
    once) and issues `instructions` FP32 lane instructions."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, instructions / FP32_INSTR_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k5_bound(B, F, n, itemsize, lower_elems):
    """(ms, by, bytes ms, chain ms) of one K5 launch. Bytes: diag, rhs and
    x once each and lower's distinct elements (the solver's -w I: n^2).
    Chain: the recursion's dependent operations, F (13 n + 2), each at one
    dependent FP32 multiply-add's latency: a forward step's two
    substitutions (2n each: a multiply-add and a division a row), its
    product with L (n + 1) and its Cholesky (3n: the square root, the
    division, the next column's update), a backward step's product with
    L^T (n + 1) and substitutions (4n). A floor: an IEEE division or
    square root takes several such latencies."""
    t_bytes = 1e3 * itemsize * (B * F * n * n + lower_elems + 2 * B * F * n) / HBM_BYTES_PER_S
    t_chain = 1e3 * F * (13 * n + 2) * DEP_CYCLES / SM_CLOCK_HZ
    return max(t_bytes, t_chain), ("bytes" if t_bytes >= t_chain else "serial chain"), t_bytes, t_chain


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def host_cpu() -> str:
    """The host's CPU model and the cores this process may use: host-bound
    phases move with them."""
    import os
    import platform

    model = None
    try:
        with open("/proc/cpuinfo") as f:
            model = next((line.split(":", 1)[1].strip() for line in f if line.startswith("model name")), None)
    except OSError:
        pass
    if model in (None, "unknown"):
        model = platform.machine()
    return f"{model}, {len(os.sched_getaffinity(0))} cores"


def cuda_ms(fn, reps: int) -> list:
    """Per-call device times (ms) of `reps` calls, by CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def queued_ms(fn, calls: int = 10) -> float:
    """Device time (ms) of one call of `fn` when its launches run back to
    back: the card first sleeps (~0.1 s) while the host enqueues `calls`
    calls, so the host's launch overhead opens no gaps between them (a
    lone call of a ~10 us kernel behind ~100 us of Python would time the
    Python). Fails if the host took longer than the sleep to enqueue."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    slept_ms = start.elapsed_time(end)  # from the first call's start: the sleep is over by then
    if host_ms >= 50.0:
        raise AssertionError(f"enqueueing {calls} calls took {host_ms:.1f} ms of host time: the sleep was too short")
    return slept_ms / calls


# kineto keeps a device event only inside the host's capture window, and a
# process's later profiler sessions tie the trace's device clock to the
# host's up to 51-153 ms off (PERF.md section 5): a profiled call starts and
# ends this far inside its window, or the card's last ops of a call it
# paces fall outside
PROFILE_MARGIN_S = 0.25


def profiled(fn, activities):
    """(torch.profiler's profile, fn's result) of one call of `fn` and the
    device work it queued, PROFILE_MARGIN_S of idle host time on either
    side."""
    import torch
    from torch.profiler import profile

    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        time.sleep(PROFILE_MARGIN_S)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    return prof, out


def device_kernels(fn) -> list:
    """[(name, device ms)] of the device kernels of one call of `fn`, by
    torch.profiler: which library kernel a yardstick runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    prof, _ = profiled(fn, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    return [(e.key[:120], round(e.self_device_time_total / 1e3, 4))
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def device_ops(fn) -> tuple:
    """(device ops, their summed device ms) of one call of `fn`, by
    torch.profiler: what a chain of small launches costs the card alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    prof, _ = profiled(fn, [ProfilerActivity.CUDA])
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.count for e in events), sum(e.self_device_time_total for e in events) / 1e3


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from grasptrajopt_tpu_torch.ops import cuda_build

    from grasptrajopt_tpu_torch import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES) + 1) as pool:
        geomcore = pool.submit(native.build, True)  # the host library (g++), beside the kernels
        results = list(pool.map(lambda n: cuda_build.build(n, force=True), KERNEL_SOURCES))
        if not geomcore.result():
            raise AssertionError("build: g++ failed on csrc/geomcore.cpp")
    print(f"[build] {len(results)} sources and csrc/geomcore.cpp (g++) in {time.perf_counter() - t0:.1f} s")
    for res in results:
        print(f"[build] {' '.join(res.command)}")
        print("[build] nvcc -Xptxas -v report:")
        for line in res.log.strip().splitlines():
            print(f"[build]   {line}")


def k1_bound(B, M, N, q_numel):
    """(ms, by) of one K1 launch: each input read once (queries, the
    (B, N, 4) rows), the (B, M) output written once, and INSTR_PER_PAIR
    FP32 instructions for each of the B x M x N pairs."""
    return bound_ms(4 * (q_numel + 4 * B * N + B * M), INSTR_PER_PAIR * B * M * N)


def phase_kernel_vs_plain(grid_pts, dev):
    """K1 against the plain version; returns (max |d2 err|, kernel ms,
    plain ms, bound ms, bound_by) where the times are the sums over the
    slice's three launch shapes. At the pipeline's B = 1 shapes also every
    forced cluster size S bit for bit against the chosen plan, and the
    plan's device time against S = 1's in turns (the split's effect)."""
    import numpy as np
    import torch

    from grasptrajopt_tpu_torch.ops import nn

    rng = np.random.default_rng(0)
    lo, hi = grid_pts.min(axis=0), grid_pts.max(axis=0)

    def clouds(B, N, valid=0.8):
        ref = torch.as_tensor(rng.uniform(lo, hi, size=(B, N, 3)), dtype=torch.float32, device=dev)
        mask = torch.as_tensor(rng.uniform(size=(B, N)) < valid, device=dev)
        return nn._pack_ref4(ref, mask)

    def points(M, *lead):
        return torch.as_tensor(rng.uniform(lo, hi, size=lead + (M, 3)), dtype=torch.float32, device=dev)

    grid = torch.as_tensor(grid_pts, dtype=torch.float32, device=dev)
    # the pre-filter's queries: 32 grasps x the gripper model's 300 points
    per_object = points(9_600, 16)
    cases = [  # (name, queries, packed clouds, "slice" / "B=1" / None)
        ("obstacle pass B=16 M=95760 N=12288", grid, clouds(16, 12_288), "slice"),
        ("target pass B=16 M=95760 N=2048", grid, clouds(16, 2_048), "slice"),
        ("pre-filter B=16 M=9600/cloud N=12288", per_object, clouds(16, 12_288), "slice"),
        # the closed-loop pipeline's launches: one cloud of H*W = 25,600
        # pixels (two fused views: 51,200), the grid, 50,000 body points a
        # replayed plan, 9,600 gripper points, the shelf's 766,080-cell grid
        # against the downsampled view
        ("tabletop field build B=1 M=95760 N=25600", grid, clouds(1, 25_600), "B=1"),
        ("replay of one plan B=1 M=50000 N=25600", points(50_000), clouds(1, 25_600), "B=1"),
        ("shelf replay, two fused views B=1 M=50000 N=51200", points(50_000), clouds(1, 51_200), "B=1"),
        ("grasp filter B=1 M=9600 N=25600", points(9_600), clouds(1, 25_600), "B=1"),
        ("shelf field build B=1 M=766080 N=14336", points(766_080), clouds(1, 14_336), "B=1"),
        ("ragged B=3 M=1000 N=1000", grid[:1_000], clouds(3, 1_000), None),
        ("ragged B=5 M=1025 N=2049", grid[:1_025], clouds(5, 2_049), None),
        ("ragged N B=1 M=20001 N=12365 (not a multiple of 8 x 512)", grid[:20_001], clouds(1, 12_365), "B=1"),
        ("ragged B=2 M=1 N=1", grid[:1], clouds(2, 1, valid=1.0), None),
    ]
    invalid = clouds(3, 2_100)
    invalid[1, :, 3] = nn.PENALTY_BIG  # cloud 1: every point invalid
    cases.append(("all-invalid cloud B=3 M=777 N=2100", grid[:777], invalid, None))
    invalid_b1 = clouds(1, 25_600)
    invalid_b1[0, :, 3] = nn.PENALTY_BIG
    cases.append(("all-invalid cloud, split B=1 M=9600 N=25600", per_object[0], invalid_b1, "B=1"))

    card = nn._k1_card(dev)
    print(f"[kernel] K1 on {card[0]} SMs, {card[1]} resident blocks of {nn.K1_TILE_M} queries an SM "
          f"(the occupancy API); the launch plan aims for {nn.K1_WAVES} x {card[0]} x {card[1]} blocks")
    max_err, k_ms, p_ms, b_ms = 0.0, 0.0, 0.0, 0.0
    for name, q, r4, kind in cases:
        got = nn.min_d2_batched(q, r4)
        want = nn.min_d2_batched_reference(q, r4)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"K1 {name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"K1 {name}: non-finite output")
        if r4 is invalid or r4 is invalid_b1:
            bad = got[1] if r4 is invalid else got[0]
            ref = want[1] if r4 is invalid else want[0]
            if not (bool((bad >= 1e38).all()) and torch.equal(bad, ref)):
                raise AssertionError(f"K1 {name}: an all-invalid cloud must give the plain version's penalty")
        err = float((got.double() - want.double()).abs().max())
        if err > FIELD_TOL:
            raise AssertionError(f"K1 {name}: max |d2 err| {err:.3e} > {FIELD_TOL:g}")
        max_err = max(max_err, err)
        B, N, _ = r4.shape
        M = q.shape[-2]
        tile_m, S = nn._k1_launch_plan(B, M, N, *card)
        line = f"[kernel] {name}: plan tile_m {tile_m} S {S}, {B * -(-M // tile_m) * S} blocks; max |d2 err| {err:.3e} m^2"
        if kind == "B=1":
            for split in (1, 2, 4, 8):
                if not torch.equal(nn.min_d2_batched(q, r4, split=split), got):
                    raise AssertionError(f"K1 {name}: split {split} differs from the plan's output")
            line += "; S = 1, 2, 4, 8 bit-identical to it"
        if kind is not None and r4 is not invalid_b1 and "ragged" not in name:
            bm, by = k1_bound(B, M, N, q.numel())
            kernel_t, plain_t, host_t = [], [], []

            def kernel_call():  # the wrapper's host time rides along
                t_host = time.perf_counter()
                nn.min_d2_batched(q, r4)
                host_t.append(1e3 * (time.perf_counter() - t_host))

            for _ in range(5):  # in turns: plain, kernel
                plain_t += cuda_ms(lambda: nn.min_d2_batched_reference(q, r4), 1)
                kernel_t += cuda_ms(kernel_call, 1)
            km, pm = statistics.median(kernel_t), statistics.median(plain_t)
            line += (f"; median kernel {km:.4f} ms (the wrapper's host time {statistics.median(host_t):.4f} "
                     f"ms of it at most), plain {pm:.4f} ms, bound {bm:.4f} ms ({by}), {bm / km:.1%} of it")
            if kind == "B=1":  # device times, the plan and S = 1 in turns
                planned_t, unsplit_t = [], []
                for _ in range(3):
                    planned_t.append(queued_ms(lambda: nn.min_d2_batched(q, r4)))
                    unsplit_t.append(queued_ms(lambda: nn.min_d2_batched(q, r4, split=1)))
                qm, um = statistics.median(planned_t), statistics.median(unsplit_t)
                blocks_sm, clusters = nn.min_d2_occupancy(dev, tile_m, S)
                line += (f"; launches queued back to back: {qm:.4f} ms a call, {bm / qm:.1%}; at S = 1 "
                         f"(tile_m {nn.K1_TILE_M}, {B * -(-M // nn.K1_TILE_M)} blocks) {um:.4f} ms, {bm / um:.1%}; "
                         f"occupancy {blocks_sm} blocks/SM, {clusters} clusters at once")
            else:
                k_ms, p_ms, b_ms = k_ms + km, p_ms + pm, b_ms + bm
        print(line, flush=True)
        del got, want
    print(f"[kernel] K1 max |d2 err| {max_err:.3e} m^2 over {len(cases)} cases (tolerance {FIELD_TOL:g}); "
          f"the slice's three passes {k_ms:.4f} ms, bound {b_ms:.4f} ms ({b_ms / k_ms:.1%})")
    return max_err, k_ms, p_ms, b_ms, by


def d2_tolerance(want):
    """K2 / K3's d2 tolerance at plain values `want` (float64)."""
    import torch

    return torch.where(want < 10.0, torch.full_like(want, NEAR_TOL), NEAR_RTOL * want)


def check_nearest(name, q, r4, normals, got, want):
    """The kernel's (d2, idx[, pt, nm]) against the plain version's on the
    same inputs; returns max |d2 err| over entries below 10 m^2."""
    import torch

    d2k, idxk, d2p, idxp = got[0], got[1], want[0], want[1]
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}: output {tuple(a.shape)} {a.dtype} != {tuple(b.shape)} {b.dtype}")
    if not torch.isfinite(d2k).all():
        raise AssertionError(f"{name}: non-finite d2")
    want64 = d2p.double()
    err = (d2k.double() - want64).abs()
    if bool((err > d2_tolerance(want64)).any()):
        raise AssertionError(f"{name}: d2 differs from plain by up to {float(err.max()):.3e}")
    C, N, _ = r4.shape
    M = d2k.shape[1]
    if bool(((idxk < 0) | (idxk >= N)).any()):
        raise AssertionError(f"{name}: index out of range")
    qb = (q if q.dim() == 3 else q[None]).double()

    def row_d2(idx):  # float64 distance (plus penalty) of each query to row idx
        rows = torch.gather(r4, 1, idx.long()[..., None].expand(C, M, 4)).double()
        return ((qb - rows[..., :3]) ** 2).sum(dim=-1) + rows[..., 3]

    dk, dp = row_d2(idxk), row_d2(idxp)
    gap = (dk - dp).abs()
    if bool((gap > d2_tolerance(dp)).any()):
        raise AssertionError(f"{name}: the kernel's nearest row is {float(gap.max()):.3e} m^2 farther than plain's")
    if len(got) == 4:
        pt = torch.gather(r4[..., :3], 1, idxk.long()[..., None].expand(C, M, 3))
        nm = torch.gather(normals, 1, idxk.long()[..., None].expand(C, M, 3))
        if not (torch.equal(got[2], pt) and torch.equal(got[3], nm)):
            raise AssertionError(f"{name}: point / normal are not the rows of the kernel's index")
    small = want64 < 10.0
    return float(err[small].max()) if bool(small.any()) else 0.0


def k2_bound(q, r4, with_normals):
    """(ms, by) of one K2 / K3 launch: the queries, the (C, N, 4) rows and
    (K2) the (C, N, 3) normals read once, d2 and the index (K2: also the
    point and its normal) written once, and INSTR_PER_PAIR FP32
    instructions for each of the C x M x N pairs: the distance-and-min
    work K1 does, the least the function needs."""
    C, N, _ = r4.shape
    M = q.shape[-2]
    n_in = q.numel() + r4.numel() + (3 * C * N if with_normals else 0)
    n_out = C * M * (8 if with_normals else 2)
    return bound_ms(4 * (n_in + n_out), INSTR_PER_PAIR * C * M * N)


def time_k2(q, r4, normals, path=None):
    """K2 / K3 at one launch shape, on pre-packed rows: the device time a
    call of the plan and of forced S = 1 with the launches queued back to
    back (queued_ms), in turns; `path` (a call of the path's own wrapper,
    packing included) queued the same way; the plain version's lone time
    (CUDA events). Returns {"plan", "queued", "unsplit", "path", "plain",
    "bound", "by"}."""
    from grasptrajopt_tpu_torch.ops import nn

    planned_t, unsplit_t, path_t, plain_t = [], [], [], []
    for _ in range(3):  # in turns: plain, plan, S = 1, path
        plain_t += cuda_ms(lambda: nn.nearest_batched_reference(q, r4, normals), 1)
        planned_t.append(queued_ms(lambda: nn.nearest_batched(q, r4, normals)))
        unsplit_t.append(queued_ms(lambda: nn.nearest_batched(q, r4, normals, split=1)))
        if path is not None:
            path_t.append(queued_ms(path))
    C, N, _ = r4.shape
    bm, by = k2_bound(q, r4, normals is not None)
    return {
        "plan": nn._k2_launch_plan(C, q.shape[-2], N, *nn._k2_card(q.device)),
        "queued": statistics.median(planned_t), "unsplit": statistics.median(unsplit_t),
        "path": statistics.median(path_t) if path_t else None, "plain": statistics.median(plain_t),
        "bound": bm, "by": by,
    }


def k2_time_line(t, C, M, N):
    """The report of one time_k2 result."""
    tile_m, S = t["plan"]
    line = (f"queued {t['queued']:.4f} ms a call ({t['bound'] / t['queued']:.1%} of the bound; plan tile_m "
            f"{tile_m} S {S}, {C * -(-M // tile_m) * S} blocks), at S = 1 {t['unsplit']:.4f} ms "
            f"({t['bound'] / t['unsplit']:.1%}); ")
    if t["path"] is not None:
        line += f"the path's min_sqdist (packing included) {t['path']:.4f} ms; "
    return line + (f"plain {t['plain']:.4f} ms; bound {t['bound']:.4f} ms ({t['by']}, 7 a pair); "
                   f"{C * M * N:.3e} pairs, {C * M * N / t['queued'] * 1e3:.3e} pairs/s")


def phase_nearest_vs_plain(grid_pts, dev, m_tier: int = 32 * 50 * 1000,
                           occupancy_shapes=((2_867, 6_438), (211_176, 11_155))):
    """K2 and K3 against the plain version; returns {"K2": (max |d2 err|,
    queued ms, plain ms, bound ms, bound_by), "K3": (...)}, the times
    summed over each mode's exact-tier launch shapes (K2: the obstacle
    and the target pass; K3: the clearance pass). Every case also at each
    forced cluster size S, bit for bit against the plan's output. m_tier:
    one object's queries in the exact tier (goal slots x T x body points);
    occupancy_shapes: (cells, points) of the mobile tabletop and shelf
    occupancy builds (phase 9's at full width)."""
    import numpy as np
    import torch

    from grasptrajopt_tpu_torch.fields.scene_points import PAD_COORD
    from grasptrajopt_tpu_torch.ops import nn

    rng = np.random.default_rng(1)
    lo, hi = grid_pts.min(axis=0), grid_pts.max(axis=0)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def ref_set(C, N, pad=0.1, valid=None):
        """(r4, normals): C sets of N points, the last `pad` share of the
        rows PAD_COORD (a fixed-capacity scene set), and an optional
        validity mask with that share of valid rows."""
        pts = rng.uniform(lo, hi, size=(C, N, 3))
        pts[:, N - int(pad * N) :] = PAD_COORD
        nrm = rng.normal(size=(C, N, 3))
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        mask = None if valid is None else f32(rng.uniform(size=(C, N)) < valid).bool()
        return nn._pack_ref4(f32(pts), mask), f32(nrm)

    def queries(C, M):
        return f32(rng.uniform(lo - 0.2, hi + 0.2, size=(C, M, 3)))

    def occupancy(M, N):
        """The occupancy build's inputs at its shape: grid cells and view
        points in the plane z = 0 (one set, shared queries)."""
        cells = np.concatenate([rng.uniform(-2.0, 3.0, size=(M, 2)), np.zeros((M, 1))], axis=1)
        pts = np.concatenate([rng.uniform(-2.0, 3.0, size=(N, 2)), np.zeros((N, 1))], axis=1)
        return f32(cells), f32(pts)

    big_q = queries(16, m_tier)
    cases = []  # (name, mode, q, r4, normals, timed: None, "record" or "shape")
    obst = ref_set(16, 4096)
    cases.append(("K2 exact tier obstacle pass C=16 M=1.6M N=4096", "K2", big_q, *obst, "record"))
    cases.append(("K2 exact tier target pass C=16 M=1.6M N=1024", "K2", big_q, *ref_set(16, 1024), "record"))
    cases.append(("K2 one-object call C=1 M=1.6M N=4096", "K2", big_q[:1].contiguous(), *ref_set(1, 4096), "shape"))
    for C, M, N in ((3, 1, 1), (2, 1025, 4097), (5, 1000, 1000), (2, 2049, 2048)):
        cases.append((f"K2 ragged C={C} M={M} N={N}", "K2", queries(C, M), *ref_set(C, N, pad=0.0), None))
    shared_q = f32(rng.uniform(lo, hi, size=(777, 3)))
    cases.append(("K2 shared queries C=3 M=777 N=3000", "K2", shared_q, *ref_set(3, 3000), None))
    all_pad = ref_set(2, 2100)
    all_pad[0][1, :, :3] = PAD_COORD  # set 1: every row is padding
    cases.append(("K2 all-PAD_COORD set C=2 M=3000 N=2100", "K2", queries(2, 3000), *all_pad, None))
    cases.append(("K3 exact tier obstacle pass, masked C=16 M=1.6M N=4096", "K3", big_q,
                  ref_set(16, 4096, valid=0.9)[0], None, "record"))
    invalid, _ = ref_set(4, 3000, pad=0.0, valid=0.6)
    invalid[2, :, 3] = nn.PENALTY_BIG  # set 2: every point invalid
    cases.append(("K3 masked, one all-invalid set C=4 M=5000 N=3000", "K3", queries(4, 5000), invalid, None, None))
    occ = {}
    for st, (M, N) in zip(("tabletop", "shelf"), occupancy_shapes):
        occ[st] = occupancy(M, N)
        cases.append((f"K3 {st} occupancy build C=1 M={M} N={N}", "K3", occ[st][0],
                      nn._pack_ref4(occ[st][1][None]), None, st))
    base = rng.uniform(lo, hi, size=(2, 3000, 3))
    dup = nn._pack_ref4(f32(np.concatenate([base, base], axis=1)))  # row n and n + 3000 coincide
    dup_n = f32(np.concatenate([np.tile([0.0, 0.0, 1.0], (2, 3000, 1)), np.tile([0.0, 0.0, -1.0], (2, 3000, 1))], axis=1))
    dup_q = f32(np.concatenate([base + 1e-3, rng.uniform(lo, hi, size=(2, 1000, 3))], axis=1))
    cases.append(("K2 exact duplicates C=2 M=4000 N=6000", "K2", dup_q, dup, dup_n, None))

    sms, blocks_sm, max_split = nn._k2_card(dev)
    splits = [1, 2, 4, 8] + ([16] if max_split == 16 else [])
    print(f"[nearest] K2 / K3 on {sms} SMs, {blocks_sm} resident blocks of {nn.K2_TILE_M} queries an SM "
          f"(the occupancy API, no share resident); clusters of up to {max_split}; the launch plan aims for "
          f"{nn.K2_WAVES} x {sms} x {blocks_sm} blocks")
    out = {"K2": [0.0, 0.0, 0.0, 0.0, None], "K3": [0.0, 0.0, 0.0, 0.0, None]}
    for name, mode, q, r4, normals, timed in cases:
        got = nn.nearest_batched(q, r4, normals)
        want = nn.nearest_batched_reference(q, r4, normals)
        torch.cuda.synchronize()
        err = check_nearest(name, q, r4, normals, got, want)
        if r4 is all_pad[0] and not bool((got[1][1] == 0).all()):
            raise AssertionError("K2: on an all-PAD_COORD set the first row must win")
        if r4 is invalid and not (bool((got[0][2] >= 1e38).all()) and bool((got[1][2] == 0).all())):
            raise AssertionError("K3: an all-invalid set must give the penalty and index 0")
        if r4 is dup and not (bool((got[1] < 3000).all()) and bool((got[3][..., 2] == 1.0).all())):
            raise AssertionError("K2: of two coincident points the first index must win")
        del want
        for split in splits:  # every forced cluster size: the plan's bits
            forced = nn.nearest_batched(q, r4, normals, split=split)
            if not all(torch.equal(a, b) for a, b in zip(forced, got)):
                raise AssertionError(f"{name}: split {split} differs from the plan's output")
            del forced
        rec = out[mode]
        rec[0] = max(rec[0], err)
        C, N, _ = r4.shape
        M = q.shape[-2]
        tile_m, S = nn._k2_launch_plan(C, M, N, sms, blocks_sm, max_split)
        line = (f"[nearest] {name}: plan tile_m {tile_m} S {S}; max |d2 err| {err:.3e} m^2 (below 10 m^2); "
                f"S = {', '.join(map(str, splits))} bit-identical to the plan")
        if timed is not None:
            path = None
            if timed in occ:
                cells, pts = occ[timed]
                path = lambda cells=cells, pts=pts: nn.min_sqdist(cells, pts)  # noqa: E731
            t = time_k2(q, r4, normals, path)
            line += "; " + k2_time_line(t, C, M, N)
            blocks, clusters = nn.nearest_occupancy(dev, N, tile_m, S)
            line += f"; occupancy {blocks} blocks/SM, {clusters} clusters at once"
            if timed == "record":
                rec[1], rec[2], rec[3], rec[4] = rec[1] + t["queued"], rec[2] + t["plain"], rec[3] + t["bound"], t["by"]
        print(line, flush=True)
        del got
    print(f"[nearest] K2 max |d2 err| {out['K2'][0]:.3e}, K3 {out['K3'][0]:.3e} m^2 over {len(cases)} cases "
          f"(tolerance {NEAR_TOL:g} m^2 below 10 m^2, {NEAR_RTOL:g} relative above); the exact tier's K2 "
          f"passes {out['K2'][1]:.4f} ms queued, bound {out['K2'][3]:.4f} ms ({out['K2'][3] / out['K2'][1]:.1%}); "
          f"K3's clearance {out['K3'][1]:.4f} ms, bound {out['K3'][3]:.4f} ms ({out['K3'][3] / out['K3'][1]:.1%})")
    return {k: tuple(v) for k, v in out.items()}


def check_plans(name, Q, qc, robot):
    """Full-q plans (..., T, ndof): finite, optimized joints within their
    limits, every joint at qc for the first two steps."""
    import torch

    lo = torch.as_tensor(robot.lower_optimized_joint_limits, dtype=Q.dtype, device=Q.device)
    hi = torch.as_tensor(robot.upper_optimized_joint_limits, dtype=Q.dtype, device=Q.device)
    Qo = robot.extract_optimized_dimensions(Q)
    if not torch.isfinite(Q).all():
        raise AssertionError(f"{name}: Q is not finite")
    if not bool(((Qo >= lo) & (Qo <= hi)).all()):
        raise AssertionError(f"{name}: Q leaves the joint limits")
    if not bool((Q[..., :2, :] == qc).all()):
        raise AssertionError(f"{name}: Q[..., :2, :] is not the start configuration")


def phase_slice(dev, cfg=None):
    """The perception-to-plan slice (e2e.PerceptionToPlan, bench_e2e.py's
    phases) at full width, warmed up and counted; returns (K1 launches of
    the counted run, K4 launches of the counted run, path, obs, out)."""
    import torch

    from grasptrajopt_tpu_torch.e2e import PerceptionToPlan, SliceConfig, collect_observations
    from grasptrajopt_tpu_torch.fields.depth_point_cloud import camera_outside, cost_fields_from_d2
    from grasptrajopt_tpu_torch.ops import interp, nn
    from grasptrajopt_tpu_torch.testing import make_synthetic_gripper, make_synthetic_gto_robot

    cfg = cfg or SliceConfig()
    t0 = time.perf_counter()
    obs = collect_observations(cfg)
    robot = make_synthetic_gto_robot(device=dev, dtype=torch.float32, points_per_link=100)
    gripper = make_synthetic_gripper(device=dev, dtype=torch.float32, points_per_link=100)
    path = PerceptionToPlan(robot, gripper, cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    print(f"[slice] set-up {time.perf_counter() - t0:.2f} s: {cfg.batch} objects, "
          f"{cfg.goal_capacity} grasps each, {robot.num_surface_points} body points, "
          f"grid {robot.grid.shape} = {robot.grid.size} cells; IK {cfg.ik_seeds} seeds x {cfg.ik_iterations} "
          f"iterations, ranking strides ({cfg.rank_t_stride}, {cfg.rank_p_stride}), coherence "
          f"{cfg.goal_coherence}, rescue_k {cfg.rescue_k}")
    path.run(obs)  # warm-up: library handles, allocator

    nn.min_d2_launches = interp.field_lookup_launches = 0
    out = path.run(obs)
    launches, k4 = nn.min_d2_launches, interp.field_lookup_launches
    want_k4 = K4_PLAN * (1 + int(cfg.rescue_k > 0))  # the plan and the rescue's single-goal solve
    if (launches, k4) != (3, want_k4):
        raise AssertionError(f"the slice launched K1 {launches} and K4 {k4} times, expected 3 and {want_k4}")

    # both fields and the pre-filter against the plain K1 on the card's clouds
    x, two = out["inputs"], out["fields"]
    grid = path.grid_pts
    d2_obs = nn.min_d2_batched_reference(grid, nn._pack_ref4(two.obs_pts, two.obs_mask))
    d2_tgt = nn.min_d2_batched_reference(grid, nn._pack_ref4(two.tgt_pts, two.tgt_mask))
    f_all, f_obs = cost_fields_from_d2(
        d2_obs, d2_tgt, x["depth"], x["K"], x["cam_pose"], x["target_mask"], grid,
        cfg.depth_threshold, cfg.field_epsilon,
    )
    field_err = max(float((f_all - two.f_all).abs().max()), float((f_obs - two.f_obs).abs().max()))
    if not field_err <= FIELD_TOL:
        raise AssertionError(f"fields differ from the plain K1 by {field_err:.3e}")
    gp, d_obs_img = path.filter_queries(x)
    d = torch.sqrt(nn.min_d2_batched_reference(gp, nn._pack_ref4(two.obs_pts, two.obs_mask)))
    sdf = torch.where(camera_outside(d_obs_img, x["K"], x["cam_pose"], gp), d, -d)
    keep = (sdf.reshape(out["keep"].shape + (-1,)) < 0).float().mean(dim=-1) <= 0.01
    if not torch.equal(keep, out["keep"]):
        raise AssertionError("the grasp pre-filter differs from the plain K1's")
    print(f"[slice] fields vs plain K1: max |err| {field_err:.3e}; pre-filter identical")

    B, T, G = cfg.batch, cfg.T, cfg.goal_capacity
    base = x["base_position"].expand(B, 3)[:, None, :]
    for name, Q in (("goal-set plan", out["Q_plan"]), ("plan after the rescue", out["Q"])):
        if tuple(Q.shape) != (B, T, robot.num_opt_joints):
            raise AssertionError(f"{name}: Q has shape {tuple(Q.shape)}")
        check_plans(f"the slice's {name}", path.full_q(Q), path.qc, robot)
    if not torch.isfinite(out["cost"]).all():
        raise AssertionError(f"non-finite plan cost: {out['cost'].tolist()}")
    if not (torch.isfinite(two.f_all).all() and torch.isfinite(two.f_obs).all()):
        raise AssertionError("non-finite cost field")
    plan_err = check_plan_fields("slice plan final fields", path.planner, out["tables"], path.full_q(out["Q"]),
                                 base, out["field_base"])

    nn.min_d2_launches = 0
    gates = path.gates(obs, out)
    gate_k1 = nn.min_d2_launches
    if gate_k1 != B:
        raise AssertionError(f"the gates' replays launched K1 {gate_k1} times, expected {B}")
    ms = {k: 1e3 * v / B for k, v in out["seconds"].items()}
    print(f"[slice] K1 launches {launches} (+ {gate_k1} in the gates' replays), K4 {k4} (plan {K4_PLAN} + "
          f"rescue {k4 - K4_PLAN}); plans finite, within limits, pinned; cost median "
          f"{float(out['cost'].median()):.4f}; final fields on the stacked table vs plain K4 (fine and coarse "
          f"passes, AoS views): max |err| {plan_err:.3e}")
    print(f"[slice] kept grasps {int(out['keep'].sum())}/{out['keep'].numel()}, "
          f"IK found {int(out['found'].sum())}/{out['found'].numel()}, "
          f"goal slots {int(out['goal_mask'].sum())}; rescue: objects {out['worst'].tolist()}, applied "
          f"{int(out['rescued'].sum())} of {cfg.rescue_k}")
    print(f"[slice] ms per object: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f", total {sum(ms.values()):.3f} ({B / sum(out['seconds'].values()):.3f} objects/s; host clock "
          f"around synchronized phases, batch {B})")
    print(f"[slice] gates: {json.dumps(gates)} (reported, not gated)")
    print(f"[slice] peak device memory {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    return launches, k4, path, obs, out


def phase_ik_collision(path, obs, out, dev):
    """The IK screen with its collision term at the slice's shape: every
    grasp of the 16 objects (512 goals x 8 seeds, 24 iterations) against
    the first object's obstacle field, packed once into one table. K4
    must launch exactly 1 + 2 x iterations times (the starting cost, then
    per iteration the linearisation and the trial candidates) and nothing
    else; K4 against plain at the solutions' body points (value and
    gradient); the same screen with the plain lookup in K4's place, timed
    in turns, and its col_cost beside the kernel run's (reported, not
    gated: one flipped LM decision moves a solution and a floor-indexed
    cost). Returns (K4 launches, max |err|)."""
    import torch

    from grasptrajopt_tpu_torch.ops import interp, nn
    from grasptrajopt_tpu_torch.planning import ik_solver
    from grasptrajopt_tpu_torch.testing import SYNTH_LINK_EE, SYNTH_LINK_GRIPPER

    cfg, robot = path.cfg, path.robot
    x = out["inputs"]
    B, G = x["tf_goal"].shape[:2]
    goals = x["tf_goal"].reshape(B * G, 4, 4)
    field = out["fields"].f_obs[0]
    ik = ik_solver.IKSolver(robot, SYNTH_LINK_EE, SYNTH_LINK_GRIPPER, iterations=cfg.ik_iterations,
                            num_seeds=cfg.ik_seeds)
    ik.setup_optimization(robot.grid)

    def solve():
        out = ik.solve_ik_batch(path.qc, goals, field, x["base_position"], multistart=True, seed=cfg.ik_seed)
        torch.cuda.synchronize(dev)
        return out

    solve()  # warm-up
    syncs = host_syncs(lambda: ik.solve_ik_batch(path.qc, goals, field, x["base_position"], multistart=True,
                                                 seed=cfg.ik_seed))
    if syncs:
        raise AssertionError(f"the IK collision screen synchronizes the host: {syncs}")
    nn.min_d2_launches = nn.nearest_launches = nn.min_sqdist_launches = interp.field_lookup_launches = 0
    t0 = time.perf_counter()
    q, err_pos, err_rot, col = solve()
    kernel_s = time.perf_counter() - t0
    counts = (nn.min_d2_launches, nn.nearest_launches, nn.min_sqdist_launches, interp.field_lookup_launches)
    want = 1 + 2 * cfg.ik_iterations
    if counts != (0, 0, 0, want):
        raise AssertionError(f"the IK collision screen launched K1-K4 {counts} times, expected (0, 0, 0, {want})")
    if not all(bool(torch.isfinite(t).all()) for t in (q, err_pos, err_rot, col)):
        raise AssertionError("the IK collision screen returned non-finite values")
    # K4 against plain where the term was last evaluated: the solutions' body points
    g = robot.grid
    table = g.pack(field)
    pts = torch.stack(robot.surface_points_soa(robot.fk_components(q), x["base_position"]), dim=-1).contiguous()
    args = (table, pts[..., 0], pts[..., 1], pts[..., 2], g.origin, g.shape, g.resolution)
    err = check_lookup(f"IK collision term at {tuple(pts.shape[:-1])} body points",
                       interp.field_lookup_packed_soa_grad(*args), interp.field_lookup_packed_soa_grad_reference(*args))

    kernel_fn = ik_solver.field_lookup_packed_soa_grad
    times = {"kernel": [kernel_s], "plain": []}
    try:
        for turn in ("plain", "kernel", "plain"):
            ik_solver.field_lookup_packed_soa_grad = (
                interp.field_lookup_packed_soa_grad_reference if turn == "plain" else kernel_fn
            )
            t0 = time.perf_counter()
            res = solve()
            times[turn].append(time.perf_counter() - t0)
            if turn == "plain":
                col_plain, found_plain = res[3], (res[1] < 0.01) & (res[2] < 5.0)
    finally:
        ik_solver.field_lookup_packed_soa_grad = kernel_fn
    found = (err_pos < 0.01) & (err_rot < 5.0)
    kernel_ms = 1e3 * statistics.median(times["kernel"]) / B
    plain_ms = 1e3 * statistics.median(times["plain"]) / B
    print(f"[ik-collision] {B * G} goals x {cfg.ik_seeds} seeds, {cfg.ik_iterations} iterations, "
          f"{robot.num_surface_points} body points, table {table.shape[0]} rows: K4 launches {counts[3]} "
          f"(1 + 2 x {cfg.ik_iterations}, as expected), K1-K3 none; host syncs in one screen "
          f"(set_sync_debug_mode): none; K4 vs plain at the solutions' body points "
          f"max |err| {err:.3e}; ms per object (host clock, synchronized): kernel {kernel_ms:.3f}, the plain "
          f"lookup in its place {plain_ms:.3f} (runs {[round(1e3 * t / B, 3) for t in times['kernel']]} / "
          f"{[round(1e3 * t / B, 3) for t in times['plain']]})")
    print(f"[ik-collision] col_cost median {float(col.median()):.4f}, max {float(col.max()):.4f}; the plain "
          f"run's: median {float(col_plain.median()):.4f}, max |difference| "
          f"{float((col - col_plain).abs().max()):.3e}, equal on {float((col == col_plain).float().mean()):.4f} "
          f"of goals; found {int(found.sum())} (plain run {int(found_plain.sum())}) of {B * G}, "
          f"with col_cost < 5 {int((found & (col < 5.0)).sum())} (reported, not gated)")
    return counts[3], err


def phase_pergoal(path, obs, out, dev):
    """The per-goal tiers after the slice; returns (K2 launches, K3
    launches) of the counted run."""
    import torch

    from grasptrajopt_tpu_torch.e2e import pergoal_reach_fractions
    from grasptrajopt_tpu_torch.ops import nn

    cfg, robot = path.cfg, path.robot
    path.pergoal(obs, out)  # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    nn.min_d2_launches = nn.nearest_launches = nn.min_sqdist_launches = 0
    pg = path.pergoal(obs, out)
    k1, k2, k3 = nn.min_d2_launches, nn.nearest_launches, nn.min_sqdist_launches
    want_k2 = 2 * (cfg.exact_iterations + 1)
    if (k1, k2, k3) != (0, want_k2, 1):
        raise AssertionError(f"per-goal tiers launched K1 {k1}, K2 {k2}, K3 {k3} times; expected 0, {want_k2}, 1")
    k4 = pg["field_lookup_launches"]
    if (k4["exact"], k4["rescue"]) != (0, 3):
        raise AssertionError(f"K4 launched {k4} times in the tiers, expected 0 in the exact and 3 in the rescue tier")
    C, G = pg["tf_goal"].shape[:2]
    n = pg["n_goals"]
    real = torch.arange(G, device=dev)[None, :] < n[:, None]
    for tier in ("exact", "rescue"):
        Q, cost = pg[f"Q_{tier}"], pg[f"cost_{tier}"]
        if tuple(Q.shape) != (C, G, cfg.T, robot.ndof):
            raise AssertionError(f"{tier} tier: Q has shape {tuple(Q.shape)}")
        check_plans(f"{tier} tier", Q, path.qc, robot)
        if not torch.isfinite(cost).all():
            raise AssertionError(f"{tier} tier: non-finite cost")

    # the exact tier's final obstacle distances: the kernel against plain
    sets = pg["sets"]
    pts = robot.fk_surface_points(pg["Q_exact"], out["inputs"]["base_position"]).reshape(C, -1, 3).contiguous()
    r4 = nn._pack_ref4(sets["scene_points"])
    err = check_nearest(
        "exact tier final obstacle distances", pts, r4, sets["scene_normals"],
        nn.nearest_batched(pts, r4, sets["scene_normals"]),
        nn.nearest_batched_reference(pts, r4, sets["scene_normals"]),
    )
    del pts, r4
    # the rescue tier's final fields: K4 against plain at the shapes, the
    # layout and the per-problem row bases of its three launches
    base = out["inputs"]["base_position"].expand(C, 3).repeat_interleave(G, dim=0)[:, None, :]
    rescue_err = check_plan_fields(
        "rescue tier final fields", path.planner, out["tables"],
        pg["Q_rescue"].reshape((C * G,) + pg["Q_rescue"].shape[2:]), base, out["field_base"].repeat_interleave(G),
    )
    print(f"[pergoal] {C} objects x {G} goal slots = {C * G} problems, real goals {int(n.sum())}; "
          f"K1 {k1}, K2 {k2}, K3 {k3} launches, K4 {k4['exact']} (exact) and {k4['rescue']} (rescue); "
          f"exact tier final obstacle d2 vs plain K2: max |err| {err:.3e} m^2; rescue tier final fields "
          f"on the stacked table vs plain K4 (fine and coarse passes, AoS views): max |err| {rescue_err:.3e}")
    ms = {k: 1e3 * v / C for k, v in pg["seconds"].items()}
    print("[pergoal] ms per object: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f" (host clock around synchronized phases, batch {C})")
    big = torch.full_like(pg["sd_exact"], float("inf"))
    for tier in ("exact", "rescue"):
        Q, cost, sd = pg[f"Q_{tier}"], pg[f"cost_{tier}"], pg[f"sd_{tier}"]
        sd_min = torch.where(real, sd, big).amin(dim=1)
        reach = pergoal_reach_fractions(robot, path.link_ee, Q, pg["tf_goal"], n)
        print(f"[pergoal] {tier} tier: Q {tuple(Q.shape)} finite, within limits, pinned; cost median "
              f"{float(cost[real].median()):.4f}; reach {json.dumps(reach)} (reported, not gated)")
        print(f"[pergoal] {tier} tier: min sd over each object's kept goals (m; points inside at "
              "step 0 left out): "
              + " ".join(f"{v:.4f}" for v in sd_min.tolist()))
    print(f"[pergoal] peak device memory {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    pergoal_replay_verdicts(path, obs, pg)
    return k2, k3


def pergoal_replay_verdicts(path, obs, pg):
    """What the replay scorer (planning/evaluate.py: more than 5 body
    points inside the obstacle cloud at a step, beyond those inside at
    step 0) says of the tiers' plans whose clearance (the points-mode
    signed distance to the 2 cm scene set) is negative: each object's real
    goal plans replayed against its full obstacle cloud, one K1 launch per
    object and tier. Reported, not gated."""
    import numpy as np

    from grasptrajopt_tpu_torch.fields.depth_point_cloud import DepthPointCloud
    from grasptrajopt_tpu_torch.planning.evaluate import score_plans_pergoal

    cfg, robot = path.cfg, path.robot
    for tier in ("exact", "rescue"):
        n_neg = n_neg_hit = n_pos = n_pos_hit = worst = 0
        for b in range(obs.depth.shape[0]):
            n_b = int(pg["n_goals"][b])
            d_obs = np.where(obs.target_mask[b], cfg.depth_threshold, obs.depth[b])
            cloud = DepthPointCloud(d_obs, obs.K, obs.cam_pose[b], obs.target_mask[b],
                                    threshold=cfg.depth_threshold, device=robot.device)
            plans = pg[f"Q_{tier}"][b, :n_b].transpose(1, 2).cpu().numpy()
            goals = pg["tf_goal"][b, :n_b].cpu().numpy()
            scores = score_plans_pergoal(robot, path.link_ee, plans, goals, cloud, obs.base_position)
            for s, sd in zip(scores, pg[f"sd_{tier}"][b, :n_b].tolist()):
                worst = max(worst, s["max_inside_points"])
                if sd < 0:
                    n_neg, n_neg_hit = n_neg + 1, n_neg_hit + int(s["collision"])
                else:
                    n_pos, n_pos_hit = n_pos + 1, n_pos_hit + int(s["collision"])
        print(f"[pergoal] {tier} tier, replay scorer on the full obstacle clouds: {n_neg_hit} of {n_neg} plans "
              f"with negative clearance collide, {n_pos_hit} of {n_pos} with clearance >= 0; at most {worst} "
              "points inside at a step beyond step 0 (reported, not gated)")


def check_lookup(name, got, want):
    """K4's (value, gx, gy, gz) against the plain version's: each within
    LOOKUP_TOL * (1 + |plain|); returns the max |err|."""
    import torch

    err = 0.0
    for label, a, b in zip(("value", "gx", "gy", "gz"), got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}: {label} {tuple(a.shape)} {a.dtype} != {tuple(b.shape)} {b.dtype}")
        d = (a.double() - b.double()).abs()
        if not bool(torch.isfinite(a).all()) or bool((d > LOOKUP_TOL * (1 + b.double().abs())).any()):
            raise AssertionError(f"{name}: {label} differs from plain by up to {float(d.max()):.3e}")
        err = max(err, float(d.max()))
    return err


def planner_points(robot, Q_full, base_position=None, stride: int = 1):
    """The body points of plans Q_full (..., T, ndof) laid out as the
    planner's Jacobian pass hands them to K4 (`field_term_value_jac`): one
    contiguous (..., T, P, 3) tensor, passed as its x / y / z views, 3
    elements apart."""
    import torch

    x, y, z = robot.surface_points_soa(robot.fk_components(Q_full), base_position, stride=stride)
    pts = torch.stack([x, y, z], dim=-1)
    return pts[..., 0], pts[..., 1], pts[..., 2]


def check_plan_fields(name, planner, table, Q_full, base_position=None, field_base=None, strides=None):
    """K4 against plain at the body points of plans Q_full (B, T, ndof), in
    the layout and with the row bases the planner gives it (the phase slab,
    plus each problem's field_base on a stacked table), at the fine stride
    and, where the planner has a coarse phase, the coarse one (or at the
    given `strides`); returns the max |err|."""
    import torch

    from grasptrajopt_tpu_torch.ops import interp

    g = planner.robot.grid
    T = Q_full.shape[-2]
    row = (torch.arange(T, device=Q_full.device) >= T + planner.standoff_offset).long()[:, None] * g.size
    if field_base is not None:
        row = row + field_base[:, None, None]
    err = 0.0
    for stride in strides or sorted({1, planner.coarse_stride if planner.coarse_iterations else 1}):
        x, y, z = planner_points(planner.robot, Q_full, base_position, stride)
        args = (table, x, y, z, g.origin, g.shape, g.resolution, row)
        got = interp.field_lookup_packed_soa_grad(*args)
        want = interp.field_lookup_packed_soa_grad_reference(*args)
        err = max(err, check_lookup(f"{name} at {tuple(x.shape)} (AoS views)", got, want))
        del got, want
    return err


def lookup_rows(x, y, z, origin, shape, resolution, row_offset):
    """The corner rows (n,) long that K4 reads: the library yardsticks
    gather these with torch.index_select and with advanced indexing."""
    from grasptrajopt_tpu_torch.ops import interp

    offs = interp._cell_and_frac(x, y, z, origin, shape, resolution)[0]
    return (offs + row_offset).reshape(-1)


def lookup_bound(rows, n_points, n_bases, row_bytes=32):
    """K4's bound for one launch: 12 B of coordinates in and 16 B of value
    and gradient out a point, a 4-byte row base per (problem, step), the
    corner rows this launch touches once each (32 B in float32, 16 B in
    bf16); about 50 FP32 instructions a point."""
    import torch

    touched = int(torch.unique(rows).numel())
    return bound_ms(28 * n_points + 4 * n_bases + row_bytes * touched, 50 * n_points)


def time_k4(table, x, y, z, origin, shape, res, row) -> dict:
    """K4 at one launch shape: the median device time a call with the
    launches queued (`queued_ms`) of the kernel, its plain version and the
    two library gathers of the same rows (torch.index_select and
    table[rows]; "library" is the faster), 5 rounds in turns; a lone
    call's CUDA-event time; the bound (`lookup_bound`) and the rows."""
    import torch

    from grasptrajopt_tpu_torch.ops import interp

    rows = lookup_rows(x, y, z, origin, shape, res, row)
    n_bases = interp._row_base(row, tuple(x.shape), x.device)[0].numel()
    kernel_t, plain_t, sel_t, idx_t = [], [], [], []
    for _ in range(5):  # in turns: plain, kernel, the two library gathers
        plain_t.append(queued_ms(lambda: interp.field_lookup_packed_soa_grad_reference(
            table, x, y, z, origin, shape, res, row_offset=row)))
        kernel_t.append(queued_ms(lambda: interp.field_lookup_packed_soa_grad(
            table, x, y, z, origin, shape, res, row_offset=row)))
        sel_t.append(queued_ms(lambda: torch.index_select(table, 0, rows)))
        idx_t.append(queued_ms(lambda: table[rows]))
    km, pm, sm, im = (statistics.median(t) for t in (kernel_t, plain_t, sel_t, idx_t))
    lone = statistics.median(cuda_ms(lambda: interp.field_lookup_packed_soa_grad(
        table, x, y, z, origin, shape, res, row_offset=row), 5))
    bm, by = lookup_bound(rows, x.numel(), n_bases, 8 * table.element_size())
    return {"kernel": km, "plain": pm, "index_select": sm, "table[rows]": im, "library": min(sm, im),
            "lone": lone, "bound": bm, "by": by, "rows": rows}


def k4_time_line(t, n_points) -> str:
    return (f"median device time a call, queued: kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, "
            f"index_select {t['index_select']:.4f} ms, table[rows] {t['table[rows]']:.4f} ms; bound "
            f"{t['bound']:.4f} ms ({t['by']}); {n_points / t['kernel'] * 1e3:.3e} points/s; a lone call "
            f"{t['lone']:.4f} ms (CUDA events, with the host's launch gaps)")


def phase_field_lookup_vs_plain(dev, bench):
    """K4 against its plain version on the same CUDA tensors: the bench's
    fine and coarse passes (the shared table, body points of the warm
    starts), the slice's stacked table, the probe's shapes, and ragged,
    outside, on-face and strided input; then the bench's passes and the
    stacked table again with the tables in bf16 (the bf16 mode). Returns
    the K4 records, float32 and bf16, of the main path's three launches a
    solve (two coarse, one fine): max |err|, kernel / plain / library /
    bound ms, bound_by."""
    import numpy as np
    import torch

    from grasptrajopt_tpu_torch.ops import interp

    robot, g = bench.robot, bench.robot.grid
    S = g.size
    gen = torch.Generator(device=dev).manual_seed(3)
    T = bench.cfg.T
    phase = (torch.arange(T, device=dev) >= T - 10).long()[:, None] * S  # (T, 1)

    def body_points(stride):
        """The warm starts' body points in the planner's two layouts: the
        Jacobian pass's x / y / z views of one (B, T, P, 3) tensor (AoS:
        every launch of the default and long-horizon solves) and the value
        pass's three tensors (SoA: the two-pass flavour's first and
        candidate passes)."""
        Q_full = bench.full_q(torch.cat([bench.qc_opt[:, None].expand(-1, 2, -1), bench.X0], dim=1))
        aos = planner_points(robot, Q_full, None, stride)
        return aos, tuple(v.contiguous() for v in aos)

    def uniform_points(lead, lo, hi):
        lo = torch.as_tensor(lo, dtype=torch.float32, device=dev)
        hi = torch.as_tensor(hi, dtype=torch.float32, device=dev)
        p = lo + torch.rand(lead + (3,), generator=gen, device=dev) * (hi - lo)
        return p[..., 0].contiguous(), p[..., 1].contiguous(), p[..., 2].contiguous()

    grid_lo = np.asarray(g.origin)
    grid_hi = grid_lo + (np.asarray(g.shape) - 1) * g.resolution
    # the slice's stacked table: 16 objects' field pairs, 98 MB
    stacked = g.pack(torch.rand((32, S), generator=gen, device=dev) * 0.1).reshape(-1, 8)
    stacked_row = phase + (torch.arange(16, device=dev) * 2 * S)[:, None, None]

    # the probe's table: two fields on a 72,576-cell grid, 145,152 rows,
    # and 1.92 M points placed in the cells its offsets name
    p_shape, p_origin, p_res = (48, 42, 36), (0.0, 0.0, 0.0), 0.05
    p_cells = 48 * 42 * 36
    probe_table = interp.pack_corners(torch.randn((2, p_cells), generator=gen, device=dev), p_shape).reshape(-1, 8)
    Qp = 1_920_000
    Sp = 2 * p_cells

    def probe_points(offs):
        f, c = offs // p_cells, offs % p_cells
        ijk = torch.stack([c // (42 * 36), (c // 36) % 42, c % 36], dim=-1).to(torch.float32)
        p = (ijk + torch.rand((offs.shape[0], 3), generator=gen, device=dev)) * p_res
        return (p[:, 0].contiguous(), p[:, 1].contiguous(), p[:, 2].contiguous()), f * p_cells

    uniform_offs = torch.randint(0, Sp, (Qp,), generator=gen, device=dev)
    jitter = torch.randint(-64, 64, (Qp,), generator=gen, device=dev)
    coherent_offs = torch.clamp(torch.arange(Qp, device=dev) * Sp // Qp + jitter, 0, Sp - 1)

    ragged_aos = torch.stack(uniform_points((3, 7, 11), grid_lo - 0.3, grid_hi + 0.3), dim=-1)
    face_idx = torch.randint(0, min(g.shape), (5, T, 40, 3), generator=gen, device=dev)
    face = torch.as_tensor(grid_lo, device=dev, dtype=torch.float32) + face_idx * g.resolution
    (fine, fine_soa), (coarse, coarse_soa) = body_points(1), body_points(2)
    cases = [  # (name, table, (x, y, z), origin, shape, res, row_offset, timed as)
        (f"bench fine pass {tuple(fine[0].shape)}, shared table, AoS views (stride 3)", bench.table, fine,
         g.origin, g.shape, g.resolution, phase, "fine"),
        (f"bench coarse pass {tuple(coarse[0].shape)}, shared table, AoS views (stride 3)", bench.table,
         coarse, g.origin, g.shape, g.resolution, phase, "coarse"),
        (f"bench fine pass {tuple(fine[0].shape)}, shared table, SoA (two-pass value passes)", bench.table,
         fine_soa, g.origin, g.shape, g.resolution, phase, "fine SoA"),
        (f"bench coarse pass {tuple(coarse[0].shape)}, shared table, SoA", bench.table, coarse_soa,
         g.origin, g.shape, g.resolution, phase, "coarse SoA"),
        (f"slice stacked table, 16 objects, {(16, T, robot.num_surface_points)}", stacked,
         uniform_points((16, T, robot.num_surface_points), grid_lo, grid_hi),
         g.origin, g.shape, g.resolution, stacked_row, "stacked"),
    ]
    for name, offs in (("uniform", uniform_offs), ("coherent +-64", coherent_offs)):
        pts, row = probe_points(offs)
        cases.append((f"probe shape S=145152 Q=1920000, {name} offsets", probe_table, pts,
                      p_origin, p_shape, p_res, row, f"probe {name}"))
    # the bf16 mode: the same tables cast after packing, as VoxelGrid.pack(dtype=bf16) casts
    table16, stacked16 = bench.table.to(torch.bfloat16), stacked.to(torch.bfloat16)
    cases += [
        (f"bf16 bench fine pass {tuple(fine[0].shape)}, shared bf16 table, AoS views", table16, fine,
         g.origin, g.shape, g.resolution, phase, "bf16 fine"),
        (f"bf16 bench coarse pass {tuple(coarse[0].shape)}, shared bf16 table, AoS views", table16, coarse,
         g.origin, g.shape, g.resolution, phase, "bf16 coarse"),
        (f"bf16 bench fine pass {tuple(fine[0].shape)}, shared bf16 table, SoA", table16, fine_soa,
         g.origin, g.shape, g.resolution, phase, "bf16 fine SoA"),
        (f"bf16 bench coarse pass {tuple(coarse[0].shape)}, shared bf16 table, SoA", table16, coarse_soa,
         g.origin, g.shape, g.resolution, phase, "bf16 coarse SoA"),
        (f"bf16 slice stacked table, 16 objects, {(16, T, robot.num_surface_points)}", stacked16,
         uniform_points((16, T, robot.num_surface_points), grid_lo, grid_hi),
         g.origin, g.shape, g.resolution, stacked_row, "bf16 stacked"),
    ]
    cases += [
        ("ragged 3 x 7 x 11, AoS views (stride 3), 0.3 m beyond the grid", bench.table,
         (ragged_aos[..., 0], ragged_aos[..., 1], ragged_aos[..., 2]), g.origin, g.shape, g.resolution,
         phase[:7], None),
        (f"points on cell faces {tuple(face.shape[:-1])}", bench.table, (face[..., 0], face[..., 1], face[..., 2]),
         g.origin, g.shape, g.resolution, phase, None),
    ]

    max_err, rec = {torch.float32: 0.0, torch.bfloat16: 0.0}, {}
    for name, table, (x, y, z), origin, shape, res, row, timed in cases:
        got = interp.field_lookup_packed_soa_grad(table, x, y, z, origin, shape, res, row_offset=row)
        want = interp.field_lookup_packed_soa_grad_reference(table, x, y, z, origin, shape, res, row_offset=row)
        torch.cuda.synchronize()
        err = check_lookup(f"K4 {name}", got, want)
        max_err[table.dtype] = max(max_err[table.dtype], err)
        line = f"[lookup] {name}: max |err| {err:.3e}"
        if name.startswith("ragged"):
            ux = (x.double() - origin[0]) / res
            outside = (ux < 0) | (ux > shape[0] - 1)
            if not (bool(outside.any()) and bool((got[1][outside] == 0).all())):
                raise AssertionError("K4: the x gradient must be zero outside the grid along x")
            line += f"; {int(outside.sum())} points outside along x, zero x gradient there"
        if timed:
            t = time_k4(table, x, y, z, origin, shape, res, row)
            if timed == "fine":
                rows = t["rows"]
                print(f"[lookup] device kernels of one library gather: index_select "
                      f"{device_kernels(lambda: torch.index_select(table, 0, rows))}, "
                      f"table[rows] {device_kernels(lambda: table[rows])}")
            rec[timed] = (t["kernel"], t["plain"], t["library"], t["bound"], t["by"])
            line += "; " + k4_time_line(t, x.numel())
        print(line)
        del got, want

    def solve_record(f, c):  # a default solve's three launches: 2 coarse + 1 fine
        return tuple(a + 2 * b for a, b in zip(f[:4], c[:4])) + (f[4],)

    out = {}
    for mode, dtype, prefix in (("float32", torch.float32, ""), ("bf16", torch.bfloat16, "bf16 ")):
        ms, plain_ms, library_ms, bound, bound_by = solve_record(rec[prefix + "fine"], rec[prefix + "coarse"])
        soa = solve_record(rec[prefix + "fine SoA"], rec[prefix + "coarse SoA"])
        out[mode] = {"max_abs_err": max_err[dtype], "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound, "bound_by": bound_by}
        n_cases = sum(1 for c in cases if c[1].dtype == dtype)
        print(f"[lookup] K4 {mode} tables: max |err| {max_err[dtype]:.3e} over {n_cases} cases (tolerance "
              f"{LOOKUP_TOL:g} x (1 + |plain|)); a default solve's three launches (2 coarse + fine, AoS views as "
              f"the planner passes them): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (the faster of "
              f"index_select and table[rows]) {library_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}); the same "
              f"passes on SoA tensors: kernel {soa[0]:.4f} ms, plain {soa[1]:.4f} ms, library {soa[2]:.4f} ms")
    return out


def kkt_system(dev, B, F, n, lower="solver", seed=5):
    """A float32 SPD block-tridiagonal system on the card: D_t = A A^T +
    (2n + 2) I; `lower` "solver" is the LM's expanded -w I (stride 0,
    w = 1), "dense" random blocks 0.3 N(0, 1)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn((B, F, n, n), generator=gen, device=dev)
    D = A @ A.transpose(-1, -2) + (2 * n + 2) * torch.eye(n, device=dev)
    if lower == "solver":
        L = (-torch.eye(n, device=dev)).expand(B, F - 1, n, n)
    else:
        L = 0.3 * torch.randn((B, F - 1, n, n), generator=gen, device=dev)
    return D, L, torch.randn((B, F, n), generator=gen, device=dev)


def phase_block_tridiag_vs_plain(dev):
    """K5 against the plain loop on the same CUDA tensors at K5_SHAPES,
    float32, with the solver's expanded -w I: the largest difference
    relative to the plain loop's largest |x| (fails above K5_RTOL), K5's
    launches a call (its counter: 1) and device time a call queued, the
    plain loop's device ops and their summed device time (torch.profiler)
    and a lone call's CUDA-event time, which the host paces; K5's bound by
    bytes and by the serial chain (`k5_bound`). Returns the record of the
    cell's shape (the first)."""
    from grasptrajopt_tpu_torch.ops import block_tridiag as bt

    out = None
    for B, F, n in K5_SHAPES:
        D, L, b = kkt_system(dev, B, F, n)
        before = bt.block_tridiag_launches
        got = bt.block_tridiag_solve(D, L, b)
        launches = bt.block_tridiag_launches - before
        want = bt.block_tridiag_solve_reference(D, L, b)
        err = float((got - want).abs().max() / want.abs().max())
        if launches != 1 or not err <= K5_RTOL:
            raise AssertionError(f"K5 at ({B}, {F}, {n}): {launches} launches, max rel diff {err:.3e} "
                                 f"(tolerance {K5_RTOL:g})")
        k_ms = statistics.median(queued_ms(lambda: bt.block_tridiag_solve(D, L, b)) for _ in range(5))
        plain_ops, plain_ms = device_ops(lambda: bt.block_tridiag_solve_reference(D, L, b))
        plain_lone = statistics.median(cuda_ms(lambda: bt.block_tridiag_solve_reference(D, L, b), 3))
        bound, by, t_bytes, t_chain = k5_bound(B, F, n, 4, n * n)
        print(f"[k5] ({B}, {F}, {n}) float32, -w I: max rel diff vs plain {err:.3e} (tolerance {K5_RTOL:g}); "
              f"launches a call: K5 {launches}, plain {plain_ops}; K5 {k_ms:.4f} ms queued; plain {plain_ms:.4f} ms "
              f"device time summed, a lone call {plain_lone:.3f} ms (CUDA events, host-paced); bound {bound:.4f} ms "
              f"({by}; bytes {t_bytes:.4f} ms, serial chain {t_chain:.4f} ms): {100 * bound / k_ms:.1f}%")
        if out is None:
            out = {"max_rel_err": err, "ms": k_ms, "plain_ms": plain_ms, "plain_lone_ms": plain_lone,
                   "bound_ms": bound, "bound_by": by, "plain_ops": plain_ops}
    return out


def phase_cr_vs_thomas(dev, B=32, T=198, n=7):
    """Cyclic reduction against the Thomas solve on the card at the long
    horizon's KKT shape (dense couplings): against K5 and against the
    plain loop; returns the max relative difference to K5."""
    from grasptrajopt_tpu_torch.ops import block_tridiag as bt

    D, L, b = kkt_system(dev, B, T, n, lower="dense", seed=4)
    x_k5 = bt.block_tridiag_solve(D, L, b)
    x_plain = bt.block_tridiag_solve_reference(D, L, b)
    x_cr = bt.block_tridiag_solve_cr(D, L, b)
    rel = float((x_cr - x_k5).abs().max() / x_k5.abs().max())
    rel_plain = float((x_cr - x_plain).abs().max() / x_plain.abs().max())
    if not (rel <= CR_RTOL and rel_plain <= CR_RTOL):
        raise AssertionError(f"cyclic reduction differs from K5 by {rel:.3e} and from the plain loop by "
                             f"{rel_plain:.3e} relative")
    t_k5 = statistics.median(queued_ms(lambda: bt.block_tridiag_solve(D, L, b)) for _ in range(3))
    t_cr = statistics.median(cuda_ms(lambda: bt.block_tridiag_solve_cr(D, L, b), 3))
    t_th = statistics.median(cuda_ms(lambda: bt.block_tridiag_solve_reference(D, L, b), 3))
    print(f"[bench] KKT ({B}, {T}, {n}, {n}): cyclic reduction vs K5 max rel diff {rel:.3e}, vs the plain "
          f"Thomas loop {rel_plain:.3e} (tolerance {CR_RTOL:g}); K5 {t_k5:.4f} ms queued; lone calls (CUDA "
          f"events): cyclic reduction {t_cr:.3f} ms, plain Thomas loop {t_th:.3f} ms")
    return rel


def phase_warm_start_report(bench):
    """How the bench's IK warm start does on its goals: the single-seed IK
    screen's share within 1 cm and within 5 degrees, the problems that
    bench.py's rule rescues (every goal beyond 1 cm), and the multistart
    IK's shares on the same goals."""
    B, cap = bench.tf_goal.shape[:2]
    goals = bench.tf_goal.reshape(B * cap, 4, 4)
    _, pos, rot, _ = bench.ik.solve_ik_batch(bench.qc, goals)
    _, pos_m, rot_m, _ = bench.ik.solve_ik_batch(bench.qc, goals, multistart=True)
    hard = int((pos.reshape(B, cap) > 0.01).all(dim=1).sum())
    print(f"[bench] IK warm start on {B * cap} goals: single seed {float((pos < 0.01).float().mean()):.4f} "
          f"within 1 cm, {float((rot < 5.0).float().mean()):.4f} within 5 degrees, median rotation error "
          f"{float(rot.median()):.2f} degrees; problems rescued {hard} of {B}; multistart "
          f"{float((pos_m < 0.01).float().mean()):.4f} within 1 cm, {float((rot_m < 5.0).float().mean()):.4f} "
          "within 5 degrees")


DEPTH_ROUNDS = 2  # rounds of the bench solve's stream at inflight 1 and 4, the order alternating
DEPTH_SOLVES = 4  # solves a depth a round
BENCH_REPS, BENCH_PIPE_REPS = 2, 4  # each flavour's latency solves (the best reported) and pipelined solves


def depth_rates(pb, bench):
    """The bench solve's sustained rate through stream_map at inflight 1
    and pb.INFLIGHT, alternated over DEPTH_ROUNDS rounds (1, 4 | 4, 1 |
    ...) of DEPTH_SOLVES solves, so a drift of the host's speed falls on
    both depths; prints each depth's rates, mean and spread, and each
    round's ratio."""
    depths = (1, pb.INFLIGHT)
    rates = {k: [] for k in depths}
    for r in range(DEPTH_ROUNDS):
        for k in depths[:: 1 if r % 2 == 0 else -1]:
            rates[k].append(pb.stream_solves(bench, DEPTH_SOLVES, k)[0])
    mean = {k: sum(v) / len(v) for k, v in rates.items()}
    ratios = [b / a for a, b in zip(rates[1], rates[pb.INFLIGHT])]
    print(f"[bench] default: the stream's depth, {DEPTH_ROUNDS} rounds of {DEPTH_SOLVES} solves a depth, "
          f"alternated: " + "; ".join(
              f"inflight {k} {[round(x, 3) for x in v]} plans/s (mean {mean[k]:.3f}, spread "
              f"{min(v):.3f}-{max(v):.3f}, {100 * (max(v) - min(v)) / mean[k]:.1f}% of the mean)"
              for k, v in rates.items())
          + f"; inflight {pb.INFLIGHT} / 1 by round {[round(x, 4) for x in ratios]}, of the means "
            f"{mean[pb.INFLIGHT] / mean[1]:.4f}")


def phase_bench(dev):
    """The port's bench solve (grasptrajopt_tpu_torch.bench) at full width
    in its four flavours, K5 and K4 against plain. Returns (the K4 records,
    float32 and bf16, K4 launches of one default and one bf16 solve, the K5
    record and K5 launches of one default solve)."""
    import torch

    from grasptrajopt_tpu_torch import bench as pb
    from grasptrajopt_tpu_torch.ops import block_tridiag, interp, nn
    from grasptrajopt_tpu_torch.testing import make_synthetic_gto_robot

    k5 = phase_block_tridiag_vs_plain(dev)
    robot = make_synthetic_gto_robot(device=dev, dtype=torch.float32, points_per_link=100)
    k4 = None
    launches = {}
    # K4 and K5 launches a solve; the long horizon solves its KKT by cyclic reduction
    for flavour, want, want5 in (("default", 3, 3), ("two_pass", 7, 3), ("long_horizon", 3, 0), ("bf16", 3, 3)):
        cfg = pb.FLAVOURS[flavour]
        t0 = time.perf_counter()
        bench = pb.SolveBench(robot, cfg)
        torch.cuda.synchronize(dev)
        print(f"[bench] {flavour}: B={cfg.batch} goals {cfg.goal_capacity} T={cfg.T} iterations {cfg.iterations} "
              f"single_pass {cfg.single_pass} coarse {cfg.coarse_iterations} final_trust {cfg.final_trust} "
              f"cyclic_reduction {cfg.cyclic_reduction}, table {cfg.field_dtype} (itemsize "
              f"{bench.table.element_size()}, {bench.gather_bytes()} corner-row bytes a solve); "
              f"{robot.num_surface_points} body points, "
              f"{robot.grid.size}-cell grid; set-up (IK warm start) {time.perf_counter() - t0:.2f} s")
        if flavour == "default":
            k4 = phase_field_lookup_vs_plain(dev, bench)
            phase_warm_start_report(bench)
        torch.cuda.reset_peak_memory_stats(dev)
        timed = pb.time_solves(bench, reps=BENCH_REPS, pipe_reps=BENCH_PIPE_REPS)
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        # no host sync inside a solve: each would drain the stream
        syncs = host_syncs(bench.step)
        if syncs:
            raise AssertionError(f"bench {flavour}: one solve synchronizes the host: {syncs}")
        if flavour == "default":
            depth_rates(pb, bench)
        nn.min_d2_launches = nn.nearest_launches = nn.min_sqdist_launches = interp.field_lookup_launches = 0
        block_tridiag.block_tridiag_launches = 0
        Q, cost, _ = bench.step()
        torch.cuda.synchronize(dev)
        counts = (nn.min_d2_launches, nn.nearest_launches, nn.min_sqdist_launches, interp.field_lookup_launches,
                  block_tridiag.block_tridiag_launches)
        if counts != (0, 0, 0, want, want5):
            raise AssertionError(f"bench {flavour}: K1-K5 launched {counts} times a solve, expected "
                                 f"(0, 0, 0, {want}, {want5})")
        launches[flavour] = counts[3]
        launches[flavour + " K5"] = counts[4]
        if tuple(Q.shape) != (cfg.batch, cfg.T, robot.num_opt_joints) or not bool(torch.isfinite(cost).all()):
            raise AssertionError(f"bench {flavour}: Q {tuple(Q.shape)}, cost {cost.tolist()}")
        check_plans(f"bench {flavour}", bench.full_q(Q), bench.qc, robot)
        err = check_plan_fields(f"bench {flavour} final fields", bench.planner, bench.table, bench.full_q(Q))
        gates = bench.gates(Q)
        print(f"[bench] {flavour}: K4 launches a solve {counts[3]}, K5 {counts[4]}; Q finite, within limits, pinned; "
              f"final fields vs plain max |err| {err:.3e}; cost median {float(cost.median()):.4f}; host syncs "
              "in one solve (set_sync_debug_mode): none")
        print(f"[bench] {flavour}: latency {timed['latency_s'] * 1e3:.3f} ms (best of "
              f"{[round(t * 1e3, 3) for t in timed['latency_runs_s']]} ms), sustained "
              f"{timed['plans_per_s']:.3f} plans/s over {BENCH_PIPE_REPS} solves through stream_map at inflight {timed['inflight']}; "
              f"peak device memory {peak:.1f} MiB")
        print(f"[bench] {flavour}: gates {json.dumps(gates)} (reported, not gated)")
        if flavour == "long_horizon":
            phase_cr_vs_thomas(dev, cfg.batch, cfg.T - 2, robot.num_opt_joints)
        del bench, timed, Q
    return k4, launches, k5


# the closed-loop phase's planner flavour: the bench's (3 iterations, single
# pass, coarse 2+1, final_trust); its kernel launches a solve
CLOSED_LOOP_FLAVOUR = dict(iterations=3, single_pass=True, coarse_iterations=2, final_trust=True)
K4_PLAN = 3  # the goal-set plan and the rescue tier: 2 coarse + 1 fine, final_trust
K4_DEEP = 13  # the deep tier: 12 iterations + the final evaluation, no coarse phase
K2_EXACT = 2 * (12 + 1)  # the exact tier: two point sets a pass, 12 iterations + 1


class TrialRecorder:
    """Per trial of the closed-loop harness: the kernel launches, the
    planner tiers that ran, each tier's solve as the solver got it (the
    planner, its per-problem params, its shared table or scene sets, the
    final Q), the replay scorings and the signed-distance queries (cloud,
    queries, result) of the trial, and what the exact tier would be given
    (the pipeline, its observation, the goal-set plan's goals and IK
    solutions, the scorer's obstacle cloud). It wraps, in this script only,
    the pipeline's entry (`plan_object`, which opens a trial), its solves
    (`GTOPlanner.plan_goalset`, `GraspPipeline._pergoal`, whose planner
    names the tier, and the solver that `GTOPlanner.setup_optimization`
    hands out), the replay scorer's two entry points and
    `DepthPointCloud.get_sdf`; `restore` undoes it."""

    def __init__(self):
        self.trials, self.cur, self._saved = [], None, []

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def install(self):
        import torch

        from grasptrajopt_tpu_torch.fields.depth_point_cloud import DepthPointCloud
        from grasptrajopt_tpu_torch.planning import evaluate
        from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner
        from grasptrajopt_tpu_torch.planning.pipeline import GraspPipeline

        rec = self

        def plan_object(orig):
            def run(pipeline, *args, **kwargs):
                rec.start()
                rec.cur.update(pipeline=pipeline, observation=args)
                t0 = time.perf_counter()
                out = orig(pipeline, *args, **kwargs)
                torch.cuda.synchronize()
                rec.cur["wall_s"] = time.perf_counter() - t0
                return out
            return run

        def plan_goalset(orig):
            def run(planner, *args, **kwargs):
                rec.cur["tiers"].append("plan")
                rec.cur["plan_args"] = (args, kwargs)
                return orig(planner, *args, **kwargs)
            return run

        def pergoal(orig):
            def run(pipeline, planner, *args, **kwargs):
                tier = {id(pipeline.planner): "rescue", id(pipeline._planner_deep): "deep",
                        id(pipeline._planner_exact): "exact"}[id(planner)]
                rec.cur["tiers"].append(tier)
                return orig(pipeline, planner, *args, **kwargs)
            return run

        def setup_optimization(orig):
            def run(planner, *args, **kwargs):
                solvers = orig(planner, *args, **kwargs)

                def record(solve):
                    def go(qc_opt, X0, params, shared):
                        out = solve(qc_opt, X0, params, shared)
                        rec.cur["solves"].append((planner, params, shared, out[0]))
                        return out
                    return go
                return type(solvers)(*(record(s) for s in solvers))
            return run

        def replay(cloud_arg):
            def make(orig):
                def run(*args, **kwargs):
                    if rec.cur is not None:  # outside a trial: not recorded
                        rec.cur["replays"] += 1
                        rec.cur["obstacle_cloud"] = args[cloud_arg]
                    return orig(*args, **kwargs)
                return run
            return make

        def get_sdf(orig):
            def run(cloud, query_points):
                out = orig(cloud, query_points)
                if rec.cur is not None:
                    rec.cur["sdf"].append((cloud, cloud._queries(query_points), out))
                return out
            return run

        self._patch(GraspPipeline, "plan_object", plan_object)
        self._patch(GTOPlanner, "plan_goalset", plan_goalset)
        self._patch(GraspPipeline, "_pergoal", pergoal)
        self._patch(GTOPlanner, "setup_optimization", setup_optimization)
        self._patch(evaluate, "check_plan_collision", replay(2))  # (robot, plan, cloud, ...)
        self._patch(evaluate, "score_plans_pergoal", replay(4))  # (robot, link, plans, goals, cloud, ...)
        self._patch(DepthPointCloud, "get_sdf", get_sdf)

    def restore(self):
        self.close()
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved = []

    def start(self):
        from grasptrajopt_tpu_torch.ops import interp, nn

        self.close()
        nn.min_d2_launches = nn.nearest_launches = nn.min_sqdist_launches = interp.field_lookup_launches = 0
        self.cur = {"tiers": [], "replays": 0, "sdf": [], "solves": []}

    def close(self):
        """Ends the open trial (its harness scoring included): reads the
        counts, keeps the signed-distance records of this trial only."""
        import torch

        from grasptrajopt_tpu_torch.ops import interp, nn

        if self.cur is None:
            return
        torch.cuda.synchronize()
        self.cur["launches"] = {"K1": nn.min_d2_launches, "K2": nn.nearest_launches,
                                "K3": nn.min_sqdist_launches, "K4": interp.field_lookup_launches}
        for t in self.trials:
            t["sdf"] = []
        self.trials.append(self.cur)
        self.cur = None


def expected_launches(trial) -> dict:
    """K1: the two field builds and the grasp filter, and one per replay
    scoring (the pipeline's and the harness's); K4: 3 for the goal-set
    plan and for the rescue, 13 for the deep tier; K2: 26 for the exact
    tier; K3 none."""
    tiers = trial["tiers"]
    return {
        "K1": 3 + trial["replays"],
        "K2": K2_EXACT * tiers.count("exact"),
        "K3": 0,
        "K4": K4_PLAN * (tiers.count("plan") + tiers.count("rescue")) + K4_DEEP * tiers.count("deep"),
    }


def check_k1_records(records):
    """K1 against its plain version on the same CUDA tensors at each B = 1
    launch of one trial: d2 within FIELD_TOL, the shaped field of a build
    within FIELD_TOL, and every replay sign (inside or not) identical.
    Returns [(M, N, max |d2 err|)] per launch."""
    import torch

    from grasptrajopt_tpu_torch.fields.depth_point_cloud import sdf_cost_shaping
    from grasptrajopt_tpu_torch.ops import nn

    out = []
    for cloud, q, got in records:
        r4 = nn._pack_ref4(cloud.points_padded[None], cloud.valid[None])
        qc = q.contiguous()
        kernel = nn.min_d2_batched(qc, r4)
        plain = nn.min_d2_batched_reference(qc, r4)
        err = float((kernel.double() - plain.double()).abs().max())
        if not err <= FIELD_TOL:
            raise AssertionError(f"K1 at B=1 M={q.shape[0]} N={r4.shape[1]}: max |d2 err| {err:.3e}")
        d = torch.sqrt(plain[0])
        want = torch.where(cloud.is_outside(qc), d, -d)
        if not torch.equal(got < 0, want < 0):
            raise AssertionError(f"K1 at B=1 M={q.shape[0]}: the inside verdicts differ from plain")
        field_err = float((sdf_cost_shaping(got) - sdf_cost_shaping(want)).abs().max())
        if not field_err <= FIELD_TOL:
            raise AssertionError(f"K1 at B=1 M={q.shape[0]}: shaped field differs from plain by {field_err:.3e}")
        out.append((q.shape[0], r4.shape[1], err))
        del kernel, plain
    return out


def time_k1(cloud, q):
    """(kernel ms, queued ms, plain ms, bound ms, bound_by, (tile_m, S))
    of K1 at one B = 1 launch: a lone call timed by CUDA events (the host's
    launch work included where the card waits on it), and the device time
    a call with the launches queued back to back (queued_ms)."""
    from grasptrajopt_tpu_torch.ops import nn

    r4 = nn._pack_ref4(cloud.points_padded[None], cloud.valid[None])
    qc = q.contiguous()
    kernel_t, plain_t = [], []
    for _ in range(3):  # in turns: plain, kernel
        plain_t += cuda_ms(lambda: nn.min_d2_batched_reference(qc, r4), 1)
        kernel_t += cuda_ms(lambda: nn.min_d2_batched(qc, r4), 1)
    qm = queued_ms(lambda: nn.min_d2_batched(qc, r4))
    M, N = qc.shape[0], r4.shape[1]
    bm, by = k1_bound(1, M, N, qc.numel())
    plan = nn._k1_launch_plan(1, M, N, *nn._k1_card(qc.device))
    return statistics.median(kernel_t), qm, statistics.median(plain_t), bm, by, plan


def check_trial_solves(name, trial):
    """Each tier's solve of one trial against the plain kernel on the
    tensors the solver got: K4 at the final plans' body points on the
    field tiers' tables (the goal-set plan's shared table, the rescue's
    and the deep tier's one-object stacked table with its row bases, the
    fine and, with a coarse phase, the coarse stride: check_plan_fields),
    and K2 at the exact tier's final body points on the scene set it
    planned against. Returns [(tier, problems, kernel, max |err|)]."""
    import torch

    from grasptrajopt_tpu_torch.ops import nn

    if len(trial["solves"]) != len(trial["tiers"]):
        raise AssertionError(f"{name}: {len(trial['solves'])} solves recorded for the tiers {trial['tiers']}")
    out = []
    for tier, (planner, params, shared, Q_opt) in zip(trial["tiers"], trial["solves"]):
        robot = planner.robot
        Q_full = robot.assemble_q(Q_opt, params["q_param"][:, None, :])
        base = params["base_position"][:, None, :]
        if "packed_fields" in shared:
            err = check_plan_fields(f"{name} {tier} final fields", planner, shared["packed_fields"], Q_full,
                                    base, params.get("field_base"))
            out.append((tier, Q_full.shape[0], "K4", err))
        else:
            C = shared["scene_points"].shape[0]
            pts = torch.stack(planner_points(robot, Q_full, base), dim=-1).reshape(C, -1, 3).contiguous()
            r4 = nn._pack_ref4(shared["scene_points"])
            err = check_nearest(
                f"{name} {tier} final obstacle distances", pts, r4, shared["scene_normals"],
                nn.nearest_batched(pts, r4, shared["scene_normals"]),
                nn.nearest_batched_reference(pts, r4, shared["scene_normals"]),
            )
            out.append((tier, Q_full.shape[0], "K2", err))
    return out


def check_escalation_tier(tier, name, trial, rec):
    """One escalation tier (`exact`: points mode, K2; `deep`: the deeper
    field re-solve, K4) on one trial's observation, goals and IK
    solutions, through the pipeline's own tier method with the arguments
    plan_object gives it (the counted trials ran the tiers only where
    their gates asked), recorded as a trial of its own. Requires the
    tier's launches (K2 = 26, or K4 = 13) and no other kernel; its plans
    finite, within the limits and pinned; the kernel against plain at the
    plans' final body points on the scene set or the table the tier
    planned against (check_trial_solves); reports the replay scorer's
    verdicts on the plans."""
    import numpy as np
    import torch

    from grasptrajopt_tpu_torch.planning.evaluate import score_plans_pergoal

    pipeline = trial["pipeline"]
    robot = pipeline.robot
    qc, depth, K, cam_pose, target_mask = trial["observation"][:5]
    args, kwargs = trial["plan_args"]  # plan_goalset(qc, RT_base, sdf_all, sdf_obs, base_position, q_solutions)
    RT_base, sdf_all, sdf_obs, base_position, q_solutions = args[1:6]
    cap = kwargs["goal_capacity"]
    n = RT_base.shape[0]

    rec.start()
    t0 = time.perf_counter()
    if tier == "exact":
        Q_e, cost_e = pipeline._plan_pergoal_exact(
            qc, RT_base, base_position, q_solutions, cap, depth, K, cam_pose, target_mask,
        )
    else:
        Q_e, cost_e = pipeline._plan_pergoal_deep(qc, RT_base, sdf_all, sdf_obs, base_position, q_solutions, cap)
    rec.close()
    wall_s = time.perf_counter() - t0
    probe = rec.trials.pop()
    want = {"K1": 0, "K2": K2_EXACT if tier == "exact" else 0, "K3": 0, "K4": K4_DEEP if tier == "deep" else 0}
    if probe["tiers"] != [tier] or probe["launches"] != want:
        raise AssertionError(f"{name}: the {tier} tier ran {probe['tiers']} and launched {probe['launches']}, "
                             f"expected [{tier!r}] and {want}")
    if Q_e.shape[:2] != (n, robot.ndof) or cost_e.shape != (n,) or not np.isfinite(cost_e).all():
        raise AssertionError(f"{name}: {tier} tier plans {Q_e.shape}, costs {cost_e.shape} (finite: "
                             f"{bool(np.isfinite(cost_e).all())}) for {n} goals")
    Q = torch.as_tensor(np.ascontiguousarray(Q_e.transpose(0, 2, 1)), dtype=robot.dtype, device=robot.device)
    check_plans(f"{name} {tier} tier", Q,
                torch.as_tensor(np.asarray(qc), dtype=robot.dtype, device=robot.device), robot)
    [(_, problems, kernel, err)] = check_trial_solves(name, probe)
    shared = probe["solves"][0][2]
    source = (f"obstacle set {int(shared['scene_mask'].sum())} of {shared['scene_points'].shape[1]} points"
              if tier == "exact" else f"table {shared['packed_fields'].shape[0]} rows")
    scores = score_plans_pergoal(
        robot, pipeline.link_ee, Q_e, RT_base, trial["obstacle_cloud"], base_position,
        pos_tol=pipeline.rescue_pos_tol, rot_tol_deg=pipeline.rescue_rot_tol_deg,
    )
    print(f"[closed-loop] {tier} tier on {name}'s observation (C=1, {cap} goal slots, {n} goals, "
          f"{len(pipeline._as_views(depth, cam_pose, target_mask)[0])} view(s), {source}): launches "
          f"{probe['launches']} (as expected), plans finite, within limits, pinned; final "
          f"{'obstacle d2' if tier == 'exact' else 'fields'} of its {problems} problems vs plain {kernel} "
          f"max |err| {err:.3e}; tier wall {wall_s:.3f} s; the replay scorer: "
          f"{sum(s['reached'] for s in scores)} of {n} reach, {sum(s['collision'] for s in scores)} "
          f"collide, {sum(s['reward'] for s in scores)} pass (reported, not gated)")


def profile_trial(fn) -> dict:
    """Where one trial's time goes: the host wall time of `fn` (the trial
    run again), then torch.profiler's device time and device operations
    over a second run of it (device_profile: device activity only, the raw
    events summed; key_averages over a trial's ~250k events took ~100 us
    an event on the host); busy = device time / unprofiled wall."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    prof = device_profile(fn)
    return {
        "seconds": time.perf_counter() - t1,
        "wall_ms": 1e3 * wall_s, "device_ms": prof["device_ms"], "device_ops": prof["ops"],
        "busy": prof["device_ms"] / (1e3 * wall_s), "top": prof["top"],
    }


CLOSED_LOOP_TABLETOP = 3  # tabletop objects of the closed loop (3 of the scene's 5: the run's time limit)


def phase_closed_loop(dev, shelf_objects: int = 3, out_dir=None, points_per_link: int = 100, size: int = 160):
    """The closed-loop harness (grasptrajopt_tpu_torch.synthetic_eval) on
    the synthetic arm and its gripper, one object a trial at full width:
    a warm-up trial, tabletop scene 10 (nearest first, CLOSED_LOOP_TABLETOP
    objects) and shelf
    scene 10 (random order, `shelf_objects` objects, 2 fused views, the
    planning fields from the first on a 2.5 cm grid). Per trial the tiers
    that ran and the exact launch counts they imply; every plan finite,
    within the limits and pinned; each solve against the plain kernel
    (check_trial_solves); the result files round-trip through
    aggregate_results; K1 at the pipeline's B = 1 launches of the last
    tabletop and the last shelf trial against plain, and timed at each
    distinct launch shape of the two; both escalation tiers on the last
    shelf trial's observation (check_escalation_tier); one trial whose goal-set plan
    failed its gates profiled."""
    import os

    import torch

    from grasptrajopt_tpu_torch import synthetic_eval as se
    from grasptrajopt_tpu_torch.testing import (
        SYNTH_EVAL_CONFIG, make_synthetic_gripper, make_synthetic_gto_robot,
    )
    from grasptrajopt_tpu_torch.utils.results import aggregate_results, load_results

    out_dir = out_dir or os.path.join(os.path.dirname(os.path.abspath(__file__)), "logs", "closed_loop")
    os.makedirs(out_dir, exist_ok=True)
    cfg = dict(SYNTH_EVAL_CONFIG)
    gripper = make_synthetic_gripper(device=dev, dtype=torch.float32, points_per_link=points_per_link)
    robots = {
        st: make_synthetic_gto_robot(device=dev, dtype=torch.float32, points_per_link=points_per_link,
                                     grid_resolution=se.SCENE_KNOBS[st]["grid_resolution"])
        for st in ("tabletop", "shelf")
    }
    flavour = dict(goal_capacity=32, width=size, height=size, coarse_stride=2, **CLOSED_LOOP_FLAVOUR)
    qc = torch.as_tensor(cfg["default_pose"], dtype=torch.float32, device=dev)

    def run(st, scene_ids, n_objects, orderings, path=None, prior=None):
        return se.evaluate_scenes(
            robots[st], gripper, cfg, scene_type=st, scene_ids=scene_ids, n_objects=n_objects,
            orderings=orderings, checkpoint_path=path, prior=prior, **flavour,
        )

    t0 = time.perf_counter()
    print(f"[closed-loop] synth7 ({robots['tabletop'].num_surface_points} body points) with its gripper "
          f"({gripper.num_surface_points} points), float32, {size}x{size}, goal capacity 32, planner "
          f"{json.dumps(CLOSED_LOOP_FLAVOUR)}; grids tabletop {robots['tabletop'].grid.size} and shelf "
          f"{robots['shelf'].grid.size} cells")
    run("tabletop", [36], 1, ["nearest_first"])  # warm-up, not counted
    print(f"[closed-loop] warm-up trial (scene 36, 1 object) {time.perf_counter() - t0:.1f} s")

    rec = TrialRecorder()
    rec.install()
    results = {}
    try:
        for st, ordering, n_obj in (("tabletop", "nearest_first", CLOSED_LOOP_TABLETOP),
                                    ("shelf", "random", shelf_objects)):
            path = os.path.join(out_dir, f"GTO_synthetic_synth7_{st}.json")
            first = len(rec.trials)
            results[st] = run(st, [10], n_obj, [ordering], path=path)
            rec.close()
            trials = rec.trials[first:]
            names = list(results[st]["10"][ordering])
            if len(trials) != len(names):
                raise AssertionError(f"{st}: {len(trials)} trials recorded for {len(names)} objects")
            for name, trial in zip(names, trials):
                r = results[st]["10"][ordering][name]
                want = expected_launches(trial)
                if trial["launches"] != want:
                    raise AssertionError(f"{st} {name}: tiers {trial['tiers']}, {trial['replays']} replays: "
                                         f"launches {trial['launches']}, expected {want}")
                tiers = trial["tiers"]
                if ("exact" in tiers or "deep" in tiers) and "rescue" not in tiers:
                    raise AssertionError(f"{st} {name}: an escalation tier ran without the rescue: {tiers}")
                if "plan" in r:
                    Q = torch.as_tensor(r["plan"], dtype=torch.float32, device=dev).T
                    check_plans(f"{st} {name}", Q, qc, robots[st])
                solved = check_trial_solves(f"{st} {name}", trial)
                trial["solves"] = None
                print(f"[closed-loop] {st} {name}: tiers {tiers}, replays {trial['replays']}, launches "
                      f"{trial['launches']} (as expected), stage {r['stage']}, reward {r['reward']}, "
                      f"rescued {r['rescued']}, escalated {r['escalated']}, err_pos {r.get('err_pos', float('nan')):.4f}, "
                      f"err_rot {r.get('err_rot', float('nan')):.2f}, max inside {r.get('max_inside_points', '-')}, "
                      f"checking / IK / planning {r['checking_time']:.3f} / {r['ik_time']:.3f} / "
                      f"{r['planning_time']:.3f} s, trial wall {trial['wall_s']:.3f} s")
                print(f"[closed-loop] {st} {name}: each solve's final plans vs plain (tier, problems, kernel, "
                      f"max |err|): " + ", ".join(f"{t} {b} {k} {e:.3e}" for t, b, k, e in solved))
            loaded = load_results(path)
            if json.dumps(loaded, sort_keys=True) != json.dumps(results[st], sort_keys=True):
                raise AssertionError(f"{st}: the result file does not round-trip")
            if aggregate_results(loaded) != aggregate_results(results[st]):
                raise AssertionError(f"{st}: aggregate_results differs on the loaded file")
            print(f"[closed-loop] {st} aggregate: {json.dumps(se.summary(loaded))} (result file {path}); "
                  f"{time.perf_counter() - t0:.1f} s into the phase")
            if st == "tabletop":
                records = trials[-1]["sdf"]
                fail = next((i for i, t in enumerate(trials) if "rescue" in t["tiers"]), len(trials) - 1)
                fail_name, fail_wall = names[fail], trials[fail]["wall_s"]
            else:  # the escalation tiers' check: the last shelf trial that planned (two fused views)
                shelf_records = trials[-1]["sdf"]
                probe_name, probe_trial = next(
                    ((n, t) for n, t in reversed(list(zip(names, trials))) if "plan_args" in t), (None, None)
                )
                if probe_trial is None:
                    raise AssertionError("no shelf trial reached the goal-set plan")
        for tier in ("exact", "deep"):
            check_escalation_tier(tier, f"shelf {probe_name}", probe_trial, rec)
        del probe_trial
    finally:
        rec.restore()

    # K1 at the pipeline's B = 1 launch shapes of the last tabletop and the
    # last shelf trial (its field builds over the downsampled first view,
    # its filter over the first view, its replays over both views fused)
    for st, recs in (("tabletop", records), ("shelf", shelf_records)):
        checked = check_k1_records(recs)
        print(f"[closed-loop] K1 vs plain at the last {st} trial's B=1 launches (M queries x N cloud "
              "points, max |d2 err|): " + ", ".join(f"{m} x {n}: {e:.3e}" for m, n, e in checked)
              + f" (tolerance {FIELD_TOL:g}); fields and inside verdicts as plain's; "
              f"{time.perf_counter() - t0:.1f} s into the phase")
    # K1 timed at every distinct B = 1 launch shape of those two trials
    shapes = {}
    for cloud, q, _ in records + shelf_records:
        shapes.setdefault((q.shape[0], cloud.points_padded.shape[0]), (cloud, q))
    trial_ms = {}
    for (M, N), (cloud, q) in sorted(shapes.items()):
        km, qm, pm, bm, by, (tile_m, S) = time_k1(cloud, q)
        trial_ms[(M, N)] = km
        print(f"[closed-loop] K1 B=1 M={M} N={N} (tile_m {tile_m}, S {S}): median kernel {km:.4f} ms "
              f"({bm / km:.1%} of the bound), queued {qm:.4f} ms ({bm / qm:.1%}), plain {pm:.4f} ms, "
              f"bound {bm:.4f} ms ({by})")
    for st, recs in (("tabletop", records), ("shelf", shelf_records)):
        total = sum(trial_ms[(q.shape[0], cloud.points_padded.shape[0])] for cloud, q, _ in recs)
        print(f"[closed-loop] K1 in the last {st} trial: {len(recs)} launches, {total:.4f} ms at the times above")
    del records, shelf_records, shapes

    # a trial whose goal-set plan failed its gates, again and profiled:
    # the other tabletop objects come from the counted run's results
    # (skipped, still removed from the scene)
    order = list(results["tabletop"]["10"]["nearest_first"])
    prior = {"10": {"nearest_first": {n: results["tabletop"]["10"]["nearest_first"][n]
                                      for n in order if n != fail_name}}}
    prof = profile_trial(lambda: run("tabletop", [10], CLOSED_LOOP_TABLETOP, ["nearest_first"], prior=prior))
    syncs = host_syncs(lambda: run("tabletop", [10], CLOSED_LOOP_TABLETOP, ["nearest_first"], prior=prior))
    print(f"[closed-loop] host syncs in trial {fail_name} (its plan, rescue and scoring; "
          f"set_sync_debug_mode): {sync_sites(syncs)}")
    print(f"[closed-loop] profile of trial {fail_name} (tabletop scene 10, its plan_object wall "
          f"{fail_wall:.3f} s in the counted run) again, with its harness scoring: "
          f"unprofiled wall {prof['wall_ms']:.1f} ms, device time {prof['device_ms']:.1f} ms, "
          f"{prof['device_ops']} device ops, busy {prof['busy']:.1%}; top {json.dumps(prof['top'])}; "
          f"the profiled run and its processing {prof['seconds']:.1f} s")

    merged = {f"{st}_10": r["10"] for st, r in results.items()}
    print(f"[closed-loop] all trials: {json.dumps(se.summary(merged))}; phase {time.perf_counter() - t0:.1f} s")


# the mobile phase's occupancy epsilon (setup_occupancy_grid's default)
OCC_EPSILON = 0.02


def check_occupancy(name, build):
    """One occupancy build's K3 launch against the plain version on the
    same CUDA tensors: d2 within NEAR_TOL, and the 0/1 grid identical cell
    for cell. Returns max |d2 err|."""
    import torch

    from grasptrajopt_tpu_torch.ops import nn

    q, ref, d2 = build["query"], build["ref"], build["d2"]
    want, _ = nn.min_sqdist_reference(q, ref)
    err = float((d2.double() - want.double()).abs().max())
    if not err <= NEAR_TOL:
        raise AssertionError(f"{name}: K3's d2 differs from plain by {err:.3e} m^2")
    plain_grid = (torch.sqrt(want) < OCC_EPSILON).to(build["grid"].dtype)
    if not torch.equal(build["grid"], plain_grid):
        flips = int((build["grid"] != plain_grid).sum())
        near = float((torch.sqrt(want.double()) - OCC_EPSILON).abs().min())
        raise AssertionError(f"{name}: {flips} occupancy cells differ from plain's (nearest cell to epsilon "
                             f"{near:.3e} m off it)")
    return err


def time_occupancy_k3(build):
    """K3 at one occupancy build's shape on the build's own CUDA tensors:
    time_k2 on the packed rows, the path's min_sqdist beside it."""
    from grasptrajopt_tpu_torch.ops import nn

    q, ref = build["query"].contiguous(), build["ref"]
    return time_k2(q, nn._pack_ref4(ref[None]), None, lambda: nn.min_sqdist(q, ref))


def phase_mobile(dev, tabletop_objects: int = 3, shelf_objects: int = 2, points_per_link: int = 100,
                 size: int = 160):
    """The mobile harness (grasptrajopt_tpu_torch.synthetic_eval_mobile) on
    the synthetic arm and its gripper at full width: tabletop scene 10
    (nearest first) and shelf scene 10 (random order), each a base
    placement from (-0.8, 0.3, yaw -0.3) on synth7's mount, then one trial
    an object in the new base frame. Per placement: exactly one K3 launch
    in the occupancy build and no other kernel, its grid identical to the
    plain version's on the same CUDA tensors (check_occupancy), the solved
    base pose finite with theta in [-pi, pi]; per trial phase 8's checks
    (expected launches, plans finite, within the limits and pinned, each
    solve against the plain kernel). Reports the tries and their
    col_cost, the base pose, the chosen grasps' errors, one base solve's
    wall time under torch.profiler, K3 at each occupancy shape, and the
    trials. Returns {"launches": K3 launches, "err", "ms", "plain_ms",
    "bound_ms", "bound_by"} summed over the placements' shapes (ms queued)."""
    import math

    import numpy as np
    import torch

    from grasptrajopt_tpu_torch import synthetic_eval_mobile as mobile
    from grasptrajopt_tpu_torch.ops import interp, nn
    from grasptrajopt_tpu_torch.planning.base_planner import BasePlanner
    from grasptrajopt_tpu_torch.planning.gto_models import GTORobotModel
    from grasptrajopt_tpu_torch.testing import (
        SYNTH_EVAL_CONFIG, make_synthetic_gripper, make_synthetic_gto_robot,
    )

    cfg = dict(SYNTH_EVAL_CONFIG)
    gripper = make_synthetic_gripper(device=dev, dtype=torch.float32, points_per_link=points_per_link)
    flavour = dict(goal_capacity=32, width=size, height=size, coarse_stride=2, **CLOSED_LOOP_FLAVOUR)
    qc = torch.as_tensor(cfg["default_pose"], dtype=torch.float32, device=dev)
    rec = TrialRecorder()
    builds, solves = [], []

    def setup_occupancy_grid(orig):
        def run(robot, points, *args, **kwargs):
            rec.close()  # the open trial's counts end here
            captured = {}
            kernel = nn.min_sqdist

            def capture(query, ref, ref_mask=None):
                out = kernel(query, ref, ref_mask)
                captured.update(query=query, ref=ref, d2=out[0])
                return out
            nn.min_d2_launches = nn.nearest_launches = nn.min_sqdist_launches = interp.field_lookup_launches = 0
            nn.min_sqdist = capture
            try:
                grid = orig(robot, points, *args, **kwargs)
            finally:
                nn.min_sqdist = kernel
            torch.cuda.synchronize()
            launches = {"K1": nn.min_d2_launches, "K2": nn.nearest_launches, "K3": nn.min_sqdist_launches,
                        "K4": interp.field_lookup_launches}
            builds.append({**captured, "grid": robot.occupancy_grid, "shape": grid.shape, "launches": launches})
            return grid
        return run

    def plan_goalset(orig):
        def run(planner, qc_, RTs, verbose=True):
            solves.append((planner, qc_, RTs))
            return orig(planner, qc_, RTs, verbose)
        return run

    rec.install()
    rec._patch(GTORobotModel, "setup_occupancy_grid", setup_occupancy_grid)
    rec._patch(BasePlanner, "plan_goalset", plan_goalset)
    t0 = time.perf_counter()
    results = {}
    try:
        for st, ordering, n_obj in (("tabletop", "nearest_first", tabletop_objects),
                                    ("shelf", "random", shelf_objects)):
            robot = make_synthetic_gto_robot(device=dev, dtype=torch.float32, points_per_link=points_per_link,
                                             grid_resolution=mobile.SCENE_KNOBS[st]["grid_resolution"])
            first, placed = len(rec.trials), []
            results[st] = mobile.evaluate_scenes(
                robot, gripper, cfg, scene_type=st, scene_ids=[10], n_objects=n_obj, orderings=[ordering],
                verbose=False, placements=placed, **flavour,
            )
            rec.close()
            trials = rec.trials[first:]
            (p,) = placed
            names = [n for n in results[st]["10"][ordering] if n != "RT_base_new"]
            if len(trials) != len(names):
                raise AssertionError(f"mobile {st}: {len(trials)} trials recorded for {len(names)} objects")
            build = builds[-1]
            if build["launches"] != {"K1": 0, "K2": 0, "K3": 1, "K4": 0}:
                raise AssertionError(f"mobile {st}: the occupancy build launched {build['launches']}, "
                                     "expected K3 once and nothing else")
            build["err"] = check_occupancy(f"mobile {st} occupancy", build)
            y = np.asarray(p["y"])
            if not (np.isfinite(y).all() and -math.pi <= y[2] <= math.pi and np.isfinite(p["RT_base_new"]).all()):
                raise AssertionError(f"mobile {st}: base pose {y.tolist()} (theta must lie in [-pi, pi])")
            last = p["tries"][-1]
            print(f"[mobile] {st} scene 10 [{ordering}], {n_obj} objects: occupancy grid {build['shape']} "
                  f"({build['grid'].numel()} cells, {int(build['grid'].sum())} occupied) from "
                  f"{build['ref'].shape[0]} points above the floor: K3 launches {build['launches']['K3']} (as "
                  f"expected), cells as plain's, max |d2 err| {build['err']:.3e} m^2; {len(p['tries'])} tries, "
                  f"col_cost {[t['col_cost'] for t in p['tries']]}; base y {np.round(y, 4).tolist()}, new base "
                  f"({p['RT_base_new'][0, 3]:.3f}, {p['RT_base_new'][1, 3]:.3f}, yaw "
                  f"{math.atan2(p['RT_base_new'][1, 0], p['RT_base_new'][0, 0]):.3f}); the chosen grasps' err_pos "
                  f"{np.round(last['err_pos'], 4).tolist()} m, err_rot {np.round(last['err_rot'], 2).tolist()} deg")
            for name, trial in zip(names, trials):
                r = results[st]["10"][ordering][name]
                want = expected_launches(trial)
                if trial["launches"] != want:
                    raise AssertionError(f"mobile {st} {name}: tiers {trial['tiers']}, {trial['replays']} replays: "
                                         f"launches {trial['launches']}, expected {want}")
                if "plan" in r:
                    Q = torch.as_tensor(r["plan"], dtype=torch.float32, device=dev).T
                    check_plans(f"mobile {st} {name}", Q, qc, robot)
                solved = check_trial_solves(f"mobile {st} {name}", trial)
                trial["solves"] = trial["sdf"] = None
                print(f"[mobile] {st} {name}: tiers {trial['tiers']}, replays {trial['replays']}, launches "
                      f"{trial['launches']} (as expected), stage {r['stage']}, reward {r['reward']}, collision "
                      f"{r.get('collision', '-')}, rescued {r['rescued']}, escalated {r['escalated']}, err_pos "
                      f"{r.get('err_pos', float('nan')):.4f}, checking / IK / planning {r['checking_time']:.3f} / "
                      f"{r['ik_time']:.3f} / {r['planning_time']:.3f} s; solves vs plain: "
                      + (", ".join(f"{t} {b} {k} {e:.3e}" for t, b, k, e in solved) or "none"))
            print(f"[mobile] {st} aggregate: {json.dumps(mobile.summary(results[st]))}; "
                  f"{time.perf_counter() - t0:.1f} s into the phase")
    finally:
        rec.restore()

    # one base solve (the shelf's last try) again: wall time and profile
    planner, qc_b, RTs_b = solves[-1]
    prof = profile_trial(lambda: planner.plan_goalset(qc_b, RTs_b, verbose=False))
    syncs = host_syncs(lambda: planner.plan_goalset(qc_b, RTs_b, verbose=False))
    print(f"[mobile] host syncs in one base solve (set_sync_debug_mode): {sync_sites(syncs)}")
    print(f"[mobile] one base solve ({RTs_b.shape[0]} goals, {planner.iterations} LM iterations, "
          f"{3 + RTs_b.shape[0] * planner.robot.num_opt_joints} variables, {planner.gripper_points.shape[0]} "
          f"gripper points): unprofiled wall {prof['wall_ms']:.1f} ms, device time {prof['device_ms']:.1f} ms, "
          f"{prof['device_ops']} device ops, busy {prof['busy']:.1%}; top {json.dumps(prof['top'])}")

    total = {"launches": len(builds), "err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": None}
    for st, build in zip(("tabletop", "shelf"), builds):
        t = time_occupancy_k3(build)
        M, N = build["query"].shape[0], build["ref"].shape[0]
        print(f"[mobile] K3 at the {st} occupancy build (C=1 M={M} N={N}), on the build's tensors: "
              + k2_time_line(t, 1, M, N))
        total["err"] = max(total["err"], build["err"])
        total["ms"] += t["queued"]
        total["plain_ms"] += t["plain"]
        total["bound_ms"] += t["bound"]
        total["bound_by"] = t["by"] if total["bound_by"] in (None, t["by"]) else "operations"
    merged = {f"{st}_10": r["10"] for st, r in results.items()}
    print(f"[mobile] all trials: {json.dumps(mobile.summary(merged))}; phase {time.perf_counter() - t0:.1f} s")
    return total


# the builder phase's limits: the DSL trajectory NLP (the JAX package's
# full-scale builder test's own checks) ...
BUILDER_RTOL = 1e-6  # the DSL cost at the structured solution against that solver's cost
BUILDER_VIOL = 1e-4  # AL-SQP constraint violation, named violations and the pinned start
BUILDER_COST_RATIO = 1.05  # the AL-SQP cost against the structured solver's
BUILDER_LIMIT_TOL = 1e-6  # joint limits of the AL-SQP plan
# ... the batched ADMM QPs against their KKT solves, and inverse dynamics
ADMM_TOL = 1e-4
DYN_TOL = 1e-10


def launch_counts() -> dict:
    from grasptrajopt_tpu_torch.ops import interp, nn

    return {"K1": nn.min_d2_launches, "K2": nn.nearest_launches - nn.min_sqdist_launches,
            "K3": nn.min_sqdist_launches, "K4": interp.field_lookup_launches}


def reset_launch_counts() -> None:
    from grasptrajopt_tpu_torch.ops import interp, nn

    nn.min_d2_launches = nn.nearest_launches = nn.min_sqdist_launches = interp.field_lookup_launches = 0


def check_dsl_solve(name, robot, sol, stats, violated, qc_opt, c_ref):
    """The full-scale builder test's checks (b) on one AL-SQP solution."""
    import numpy as np

    Q = sol[f"{robot.get_name()}/q"]
    n = robot.num_opt_joints
    lo, hi = robot.lower_optimized_joint_limits, robot.upper_optimized_joint_limits
    problems = []
    if not np.isfinite(Q).all():
        problems.append("non-finite plan")
    if not stats["constraint_violation"] < BUILDER_VIOL:
        problems.append(f"constraint violation {stats['constraint_violation']:.3e}")
    if violated:
        problems.append(f"violated constraints {violated}")
    if not sol["f"] <= BUILDER_COST_RATIO * c_ref:
        problems.append(f"cost {sol['f']:.6f} above {BUILDER_COST_RATIO} x {c_ref:.6f}")
    start = float(np.abs(Q[:n, 0] - qc_opt).max())
    if not start <= BUILDER_VIOL:
        problems.append(f"start {start:.3e} from qc")
    if not ((Q[:n].min(axis=1) >= lo - BUILDER_LIMIT_TOL).all() and (Q[:n].max(axis=1) <= hi + BUILDER_LIMIT_TOL).all()):
        problems.append("joint limits")
    if problems:
        raise AssertionError(f"{name}: " + "; ".join(problems))


def phase_builder(dev, points_per_link: int = 100, T: int = 50, config=None, sdf_points: int = 131_072,
                  qp_shape=(16, 256, 32)):
    """The builder stack (grasptrajopt_tpu_torch.opt: OptimizationBuilder,
    the AL-SQP, ADMM and SciPy solvers; models/dynamics; the SDF program)
    on the card: planar IK (LM and SLSQP within 1e-4 of the target); the
    DSL trajectory NLP at full width (formulation check against the
    structured planner, then the AL-SQP solve, counted, timed and
    profiled); the SDF program against K4 on `sdf_points` points; a batch
    of equality-constrained QPs through ADMM against their KKT solves; the
    double pendulum's rnea against M qdd + C + g."""
    from unittest import mock

    import numpy as np
    import torch

    from grasptrajopt_tpu_torch import planar_ik
    from grasptrajopt_tpu_torch.fields import sdf_value_jac_hess
    from grasptrajopt_tpu_torch.models import RobotModel
    from grasptrajopt_tpu_torch.models.dynamics import coriolis_vector, gravity_vector, mass_matrix
    from grasptrajopt_tpu_torch.ops import interp
    from grasptrajopt_tpu_torch.opt import ALSQPConfig, ALSQPSolver, solve_qp_admm
    from grasptrajopt_tpu_torch.planning import gto_planner
    from grasptrajopt_tpu_torch.testing import (
        DOUBLE_PENDULUM_URDF,
        SYNTH_DEFAULT_POSE,
        SYNTH_LINK_EE,
        SYNTH_LINK_GRIPPER,
        make_dsl_trajectory_problem,
        make_synthetic_goal,
        make_synthetic_gto_robot,
        make_synthetic_scene_field,
    )

    t0 = time.perf_counter()
    f64 = torch.float64

    # planar IK: the LM solve on the card, SLSQP on the host with the
    # derivatives from the card
    ik = planar_ik.solve(dev)
    ik_err = {}
    for label, key in (("LM", "reached"), ("SLSQP", "reached_slsqp")):
        ik_err[label] = float(np.linalg.norm(ik[key] - np.asarray(planar_ik.TARGET)))
        if not ik_err[label] < planar_ik.REACH_TOL:
            raise AssertionError(f"planar IK: the {label} solution misses the target by {ik_err[label]:.3e}")
    print(f"[builder] planar IK: LM {ik['lm'][0]} (reach error {ik_err['LM']:.3e}), SLSQP {ik['slsqp'][0]} "
          f"({ik_err['SLSQP']:.3e}); both within {planar_ik.REACH_TOL}")

    # the DSL trajectory NLP at full width, float64
    robot = make_synthetic_gto_robot(device=dev, dtype=f64, points_per_link=points_per_link)
    field = make_synthetic_scene_field(robot)
    qc = SYNTH_DEFAULT_POSE.astype(np.float64)
    prob = make_dsl_trajectory_problem(robot, field, make_synthetic_goal(0), qc, T=T)
    n_opt = robot.num_opt_joints
    if prob.opt.nx != n_opt * T + n_opt * (T - 1):
        raise AssertionError(f"the DSL NLP has {prob.opt.nx} decision variables")
    qc_opt = qc[robot.optimized_joint_indexes]

    # the structured reference (GTOPlanner, 80 iterations) in float64: K4
    # takes float32 only, so here the planner looks its field up with K4's
    # plain version, named explicitly
    planner = gto_planner.GTOPlanner(robot, SYNTH_LINK_EE, SYNTH_LINK_GRIPPER, iterations=80, T=T)
    solve_ref = planner.setup_optimization(1, True, "z").solve_batch_shared
    qc_t = torch.as_tensor(qc_opt, dtype=f64, device=dev)
    field_t = torch.as_tensor(field, dtype=f64, device=dev)
    params = {
        "q_param": torch.as_tensor(qc[robot.parameter_joint_indexes], dtype=f64, device=dev)[None],
        "tf_goal": torch.as_tensor(make_synthetic_goal(0), dtype=f64, device=dev)[None, None],
        "goal_mask": torch.ones((1, 1), dtype=torch.bool, device=dev),
        "base_position": torch.zeros((1, 3), dtype=f64, device=dev),
    }
    reset_launch_counts()
    t_ref = time.perf_counter()
    with mock.patch.object(gto_planner, "field_lookup_packed_soa_grad",
                           interp.field_lookup_packed_soa_grad_reference):
        Q_ref, c_ref, _ = solve_ref(qc_t[None], qc_t.expand(T - 2, -1)[None], params,
                                    {"packed_fields": planner.field_table(field_t, field_t)})
    c_ref = float(c_ref[0])
    t_ref = time.perf_counter() - t_ref
    if any(launch_counts().values()):
        raise AssertionError(f"the float64 structured reference launched kernels: {launch_counts()}")

    cfg = config or ALSQPConfig(outer_iterations=8, inner_iterations=12)
    solver = ALSQPSolver(prob.opt).setup(prob.lo, prob.hi, cfg)
    solver.reset_initial_seed(prob.seed)
    solver.reset_parameters(prob.params)

    # (a) the DSL states the structured planner's objective
    q_blocks = Q_ref[0].T
    x_ref = prob.opt.x_layout.vec(
        {robot.state_optimized_name(0): q_blocks,
         robot.state_optimized_name(1): (q_blocks[:, 1:] - q_blocks[:, :-1]) / prob.dt},
        f64, dev,
    )
    p = prob.opt.p_layout.vec(prob.params, f64, dev)
    f_ref = solver.evaluate_cost(xvec=x_ref)
    rel = abs(f_ref - c_ref) / abs(c_ref)
    if not rel <= BUILDER_RTOL:
        raise AssertionError(f"the DSL cost at the structured solution {f_ref!r} differs from the solver's "
                             f"{c_ref!r} by {rel:.3e} relative")
    print(f"[builder] DSL NLP: synth7 at {points_per_link} points per link ({robot.num_surface_points} surface "
          f"points), T = {T}, {prob.opt.nx} decision variables, {prob.opt.h(x_ref, p).shape[0]} "
          f"equalities, {prob.opt.g(x_ref, p).shape[0]} inequalities, float64; (a) the DSL cost at "
          f"the structured solution {f_ref:.9f} against the structured solver's {c_ref:.9f} (relative "
          f"{rel:.3e}, limit {BUILDER_RTOL}; the structured solve {t_ref:.2f} s)")

    # (b) the AL-SQP solve: once for the wall clock, once under the profiler
    solves = []

    def solve():
        sol = solver.solve()
        solves.append((sol, solver.stats()))

    torch.cuda.synchronize()
    reset_launch_counts()
    base_bytes = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    prof = profile_trial(solve)
    peak = torch.cuda.max_memory_allocated(dev)
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the AL-SQP path launched kernels: {counts}")
    for i, (sol, stats) in enumerate(solves):
        x = prob.opt.x_layout.vec({k: sol[k] for k in prob.opt.x_layout.shapes}, f64, dev)
        violated = solver.violated_constraints(xvec=x, tol=BUILDER_VIOL)
        check_dsl_solve(f"AL-SQP solve {i}", robot, sol, stats, violated, qc_opt, c_ref)
    sol, stats = solves[0]
    print(f"[builder] (b) ALSQPSolver, {cfg.outer_iterations} outer x {cfg.inner_iterations} inner iterations: "
          f"f {sol['f']:.9f} (<= {BUILDER_COST_RATIO} x the structured {c_ref:.9f}: ratio "
          f"{sol['f'] / c_ref:.4f}), constraint violation {stats['constraint_violation']:.3e}, no named "
          f"violation above {BUILDER_VIOL}, start within {BUILDER_VIOL} of qc, joint limits held; kernel "
          f"launches {counts} (this path runs none)")
    print(f"[builder] AL-SQP solve: wall {prof['wall_ms']:.1f} ms (host clock, synchronized), device "
          f"{prof['device_ms']:.1f} ms in {prof['device_ops']} device ops (torch.profiler, a second solve), "
          f"busy {100 * prof['busy']:.1f}% (the profiled solve {prof['seconds']:.1f} s), peak memory {peak / 2**30:.2f} GiB ({(peak - base_bytes) / 2**30:.2f} "
          f"GiB above the {base_bytes / 2**30:.2f} GiB held before it); top device ops {prof['top']}")

    # the SDF program (autodiff of the plain trilinear lookup) against K4
    # at the same float32 points: half over the grid, half over the table
    g = robot.grid
    field32 = torch.as_tensor(field, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    u = torch.rand((sdf_points, 3), generator=gen, dtype=torch.float32, device=dev)
    span = torch.tensor([(s - 1) * g.resolution for s in g.shape], dtype=torch.float32, device=dev)
    origin = torch.tensor(g.origin, dtype=torch.float32, device=dev)
    slab_lo = torch.tensor([0.25, -0.35, 0.30], dtype=torch.float32, device=dev)
    slab_span = torch.tensor([0.70, 0.70, 0.20], dtype=torch.float32, device=dev)
    half = sdf_points // 2
    pts = torch.cat([origin + u[:half] * span, slab_lo + u[half:] * slab_span])
    vals, jac, hess = sdf_value_jac_hess(g, field32, pts)
    k4 = interp.field_lookup_packed_soa_grad(g.pack(field32), pts[:, 0], pts[:, 1], pts[:, 2], g.origin,
                                             g.shape, g.resolution)
    sdf_err = check_lookup("SDF program vs K4", k4, (vals, jac[:, 0], jac[:, 1], jac[:, 2]))
    asym = (hess - hess.transpose(1, 2)).abs()
    if bool((asym > LOOKUP_TOL * (1 + hess.abs())).any()):
        raise AssertionError(f"SDF program: the Hessian is not symmetric (up to {float(asym.max()):.3e})")
    if bool((torch.diagonal(hess, dim1=1, dim2=2) != 0).any()):
        raise AssertionError("SDF program: a pure second derivative is not 0 inside its cell")
    live = int((jac.abs().sum(dim=1) > 0).sum())
    print(f"[builder] SDF program: {sdf_points} points (float32), value and gradient against K4 max |err| "
          f"{sdf_err:.3e} (limit {LOOKUP_TOL} x (1 + |value|)), {live} points with a nonzero gradient; the "
          f"Hessian symmetric (max |H - H^T| {float(asym.max()):.3e}), pure second derivatives 0")

    # ADMM: a batch of equality-constrained QPs against their KKT solves
    B, n, m = qp_shape
    cpu_gen = torch.Generator().manual_seed(1)
    M = torch.randn((B, n, n), generator=cpu_gen, dtype=f64) / n**0.5
    P = M @ M.mT + torch.eye(n, dtype=f64)
    q = torch.randn((B, n), generator=cpu_gen, dtype=f64)
    A = torch.randn((B, m, n), generator=cpu_gen, dtype=f64) / n**0.5
    b = torch.randn((B, m), generator=cpu_gen, dtype=f64)
    P, q, A, b = (t.to(dev) for t in (P, q, A, b))
    x, _, _, res = solve_qp_admm(P, q, A, b, b)
    kkt = torch.cat([torch.cat([P, A.mT], dim=2),
                     torch.cat([A, torch.zeros((B, m, m), dtype=f64, device=dev)], dim=2)], dim=1)
    want = torch.linalg.solve(kkt, torch.cat([-q, b], dim=1))[:, :n]
    admm_err = float((x - want).abs().max())
    if not admm_err <= ADMM_TOL:
        raise AssertionError(f"ADMM: {B} QPs of {n} variables and {m} equalities off their KKT solves by {admm_err:.3e}")
    print(f"[builder] ADMM: {B} QPs of {n} variables and {m} equalities in one call, max |x - KKT| {admm_err:.3e} "
          f"(limit {ADMM_TOL}), primal residual {float(res['primal_res'].max()):.3e}")

    # inverse dynamics: rnea = M qdd + C + g on the double pendulum
    pend = RobotModel(urdf_string=DOUBLE_PENDULUM_URDF, dtype=f64, device=dev)
    states = torch.rand((4, 3, 2), generator=cpu_gen, dtype=f64).to(dev) * 3.0 - 1.5
    dyn_err = 0.0
    for qs, qds, qdds in states:
        tau = pend.rnea(qs, qds, qdds)
        split = mass_matrix(pend, qs) @ qdds + coriolis_vector(pend, qs, qds) + gravity_vector(pend, qs)
        dyn_err = max(dyn_err, float((tau - split).abs().max()))
    if not dyn_err <= DYN_TOL:
        raise AssertionError(f"rnea differs from M qdd + C + g by {dyn_err:.3e}")
    print(f"[builder] double pendulum: rnea against M qdd + C + g at {states.shape[0]} states, max |err| "
          f"{dyn_err:.3e} (limit {DYN_TOL}); phase {time.perf_counter() - t0:.1f} s")


# the serving phase's limits: retimed plans against the served plans and
# synth7's velocity limits, the fake's end-effector against the card's FK
RETIME_END_TOL = 1e-3  # rad, the retimed trajectory's first and last samples
RETIME_VEL_FACTOR = 1.05  # |qd| within this factor of the velocity limits
EXECUTE_TOL = 1e-5  # m, the fake's end-effector position against the FK on the card


def k4_per_solve(planner) -> int:
    """K4 launches of one solve of `planner`'s TrajectoryConfig: the
    two-pass LM looks up once for the start cost and twice an iteration
    (the linearisation and the candidate pass); the single-pass LM once an
    iteration (coarse ones included), plus the post-scan pass unless
    final_trust skips it."""
    if not planner.single_pass:
        return 1 + 2 * planner.iterations
    return planner.iterations + (0 if planner.final_trust else 1)


def host_syncs(fn) -> dict:
    """{file:line: count} of the synchronizing CUDA operations one call of
    `fn` makes (the program's `profiling.count_syncs`: each attributed to
    the innermost frame of the port on the stack, the line that reached
    the sync, also through torch's own Python)."""
    import torch

    from grasptrajopt_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    with profiling.count_syncs() as sites:
        fn()
    torch.cuda.synchronize()
    return dict(sites)


def sync_sites(syncs: dict) -> str:
    """`host_syncs`'s counts, most first, with their total."""
    if not syncs:
        return "none"
    return f"{sum(syncs.values())}: " + ", ".join(f"{k} {v}" for k, v in sorted(syncs.items(), key=lambda kv: -kv[1]))


def phase_serving(dev, batch: int = 16, batches: int = 8, inflight: int = 4, iterations: int = 10, goals: int = 4,
                  out_dir=None):
    """Serving and execution: the serving demo (throughput_serving) at its
    defaults, retiming of served plans, one plan executed on the port's
    fake PyBullet, where a served solve's time goes and a trace of one
    served solve, and the native geometry library. Returns the K4 launches
    of one served solve."""
    import collections
    import os
    import shutil
    import sys as _sys
    from unittest import mock

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from grasptrajopt_tpu_torch import native
    from grasptrajopt_tpu_torch import throughput_serving as serving
    from grasptrajopt_tpu_torch.envs import fake_pybullet
    from grasptrajopt_tpu_torch.envs.synthetic import SyntheticSceneEnv
    from grasptrajopt_tpu_torch.planning.retiming import convert_plan_to_trajectory
    from grasptrajopt_tpu_torch.testing import SYNTH_ARM_URDF, SYNTH_LINK_EE
    from grasptrajopt_tpu_torch.utils.profiling import PhaseTimer, trace

    t_phase = time.perf_counter()
    out_dir = out_dir or os.path.join(os.path.dirname(os.path.abspath(__file__)), "logs", "serving")
    os.makedirs(out_dir, exist_ok=True)
    timer = PhaseTimer(sync=True, device=dev)

    # the demo at its defaults: B problems a request, each with its own field
    with timer.phase("setup"):
        server = serving.Server(iterations=iterations, goals=goals, device=dev)
        requests = [server.request(seed, batch) for seed in range(batches)]
    planner, robot = server.planner, server.robot
    per_solve = k4_per_solve(planner)
    reset_launch_counts()
    with timer.phase("serve"):
        out = serving.serve(server, requests, inflight)
    counts = launch_counts()
    want = {"K1": 0, "K2": 0, "K3": 0, "K4": (1 + 2 * batches) * per_solve}
    if counts != want:
        raise AssertionError(f"serving: launches {counts} over {1 + 2 * batches} solves, expected {want}")
    if out["retired_by_submit"] != max(0, batches - inflight):
        raise AssertionError(f"serving: submit retired {out['retired_by_submit']} of {batches} requests at depth "
                             f"{inflight}, expected {max(0, batches - inflight)}")
    print(f"[serving] demo: {batches} requests of {batch} problems x {goals} goals, synth7 at 32 points per link "
          f"({robot.num_surface_points} body points), GTOPlanner(iterations={iterations}) (single_pass "
          f"{planner.single_pass}, T = {planner.T}), standoff along z, a stacked table of {batch} fields a "
          f"request; launches over the warm-up, {batches} synchronous and {batches} pipelined solves {counts}: "
          f"K4 {per_solve} a solve (1 + 2 x {iterations}), K1-K3 none")

    with timer.phase("check"):
        qc = torch.as_tensor(server.qc, device=dev)
        for i, ((Qs, cs), (Qp, cp)) in enumerate(zip(out["sync"], out["pipelined"])):
            if not (torch.equal(Qs, Qp) and torch.equal(cs, cp)):
                raise AssertionError(f"serving: request {i}'s pipelined plans differ from the synchronous ones by "
                                     f"{float((Qs - Qp).abs().max()):.3e} rad, costs by {float((cs - cp).abs().max()):.3e}")
            if tuple(Qs.shape) != (batch, planner.T, robot.num_opt_joints) or not bool(torch.isfinite(cs).all()):
                raise AssertionError(f"serving: request {i}: Q {tuple(Qs.shape)}, cost finite {bool(torch.isfinite(cs).all())}")
            check_plans(f"served request {i}", robot.assemble_q(Qs, requests[i][2]["q_param"][:, None, :]), qc, robot)
        last = requests[-1][2]
        Q_last = robot.assemble_q(out["sync"][-1][0], last["q_param"][:, None, :])
        tables, base = planner.pack_stacked_fields(last["sdf_cost_all"], last["sdf_cost_obstacle"])
        k4_err = check_plan_fields("served plans' final fields", planner, tables, Q_last, field_base=base,
                                   strides=(1, planner.coarse_stride))
        del tables
    print(f"[serving] every request's pipelined (Q, cost) bit-identical to the synchronous loop's; every plan "
          f"finite, within the joint limits and pinned; K4 against plain at the last request's final body points "
          f"on its stacked table ({batch} slabs, row bases {base.tolist()[:3]}...), strides 1 and "
          f"{planner.coarse_stride}: max |err| {k4_err:.3e} (tolerance {LOOKUP_TOL:g} x (1 + |plain|))")
    solve_ms = [round(1e3 * t, 1) for t in out["sync_solve_s"]]
    submit_ms = [round(1e3 * t, 1) for t in out["submit_s"]]
    print(f"[serving] synchronous {out['sync_plans_per_s']:.3f} plans/s ({out['sync_s']:.3f} s), pipelined "
          f"(inflight {inflight}) {out['pipelined_plans_per_s']:.3f} plans/s ({out['pipelined_s']:.3f} s), ratio "
          f"{out['ratio']:.4f}; host time a submit {out['submit_ms']:.3f} ms; submit retired "
          f"{out['retired_by_submit']} of {batches} results at the depth bound, drain the rest; the synchronous "
          f"solves {solve_ms} ms (spread {100 * (max(solve_ms) - min(solve_ms)) / (sum(solve_ms) / batches):.1f}% "
          f"of the mean), the submits {submit_ms} ms")

    # where a served solve waits on the host and where its device time goes
    # (device activity only: with the host's ~700k op events the profile
    # took ~50 s); then a trace() of a served solve of a one-iteration
    # server, the same path at 1 + 2 x 1 K4 launches
    with timer.phase("profile"):
        prof, syncs = profiled(lambda: host_syncs(lambda: server.solve(*requests[0])), [ProfilerActivity.CUDA])
        device_ns = collections.Counter()
        device_n = collections.Counter()
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                device_ns[e.name()] += e.duration_ns()
                device_n[e.name()] += 1
        del prof
        device_ms = sum(device_ns.values()) / 1e6
        k4_names = [k for k in device_ns if "field_lookup_kernel" in k]
        wall_ms = 1e3 * out["sync_s"] / batches
        top = [[k[:60], device_n[k], round(v / 1e6, 3)] for k, v in device_ns.most_common(6)]
        if sum(device_n[k] for k in k4_names) != per_solve:
            raise AssertionError(f"serving: the profiled solve ran K4 {sum(device_n[k] for k in k4_names)} times, "
                                 f"expected {per_solve}")
        small = serving.Server(iterations=1, goals=goals, device=dev)
        small_request = small.request(0, batch)
        small.solve(*small_request)
        logdir = os.path.join(out_dir, "trace")
        shutil.rmtree(logdir, ignore_errors=True)
        t_trace = time.perf_counter()
        with trace(logdir):
            small.solve(*small_request)
            torch.cuda.synchronize(dev)
        files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
        if len(files) != 1:
            raise AssertionError(f"serving: trace() wrote {os.listdir(logdir)}")
        trace_path = os.path.join(logdir, files[0])
        with open(trace_path) as f:
            names_k4 = any("field_lookup_kernel" in line for line in f)
        if not names_k4:
            raise AssertionError(f"serving: the trace {trace_path} names no field_lookup_kernel (K4)")
        t_trace = time.perf_counter() - t_trace
        del small, small_request
    if syncs:
        raise AssertionError(f"serving: one served solve synchronizes the host: {syncs}")
    print("[serving] host syncs in one served solve (set_sync_debug_mode): none")
    print(f"[serving] one served solve: wall {wall_ms:.1f} ms (the synchronous loop's mean), device {device_ms:.1f} ms "
          f"in {sum(device_n.values())} device ops (torch.profiler, device activity), busy "
          f"{100 * device_ms / wall_ms:.1f}%; K4 {sum(device_n[k] for k in k4_names)} launches, "
          f"{sum(device_ns[k] for k in k4_names) / 1e6:.3f} ms; top device ops {top}")
    print(f"[serving] utils.profiling.trace of a served solve at iterations=1: {trace_path} "
          f"({os.path.getsize(trace_path) / 2**20:.1f} MiB, names field_lookup_kernel; traced and read in "
          f"{t_trace:.1f} s)")

    # retiming and execution on the port's fake PyBullet
    with timer.phase("execute"):
        vmax = robot.velocity_optimized_joint_limits
        Q_served = out["sync"][0][0]
        retimed = []
        for b in range(min(4, batch)):
            plan = Q_served[b].T  # (7, T) on the card: retiming brings it to the host
            qs, qds, qdds, ts = convert_plan_to_trajectory(robot, plan)
            host = plan.double().cpu().numpy()
            ends = max(float(np.abs(qs[0] - host[:, 0]).max()), float(np.abs(qs[-1] - host[:, -1]).max()))
            vel = float((np.abs(qds) / vmax).max())
            if not (np.isfinite(qs).all() and ends <= RETIME_END_TOL and vel <= RETIME_VEL_FACTOR):
                raise AssertionError(f"retimed plan {b}: endpoints off by {ends:.3e} rad, |qd| up to {vel:.3f} x "
                                     "the velocity limits")
            retimed.append((qs, ts, ends, vel))
        urdf = os.path.join(out_dir, "synth7.urdf")
        with open(urdf, "w") as f:
            f.write(SYNTH_ARM_URDF)
        previous = _sys.modules.get("pybullet")
        fake_pybullet.install(force=True)
        try:
            from grasptrajopt_tpu_torch.envs.pybullet_api import FixedBaseRobot

            fake_pybullet.resetSimulation()
            arm = FixedBaseRobot(urdf)
            fingers = server.qc[7:].astype(np.float64)
            qs = retimed[0][0]
            arm.reset(np.concatenate([qs[0], fingers]))
            arm.execute_plan(np.concatenate([qs, np.tile(fingers, (len(qs), 1))], axis=1).T)
            names = [fake_pybullet.getJointInfo(arm._id, j)[12].decode() for j in range(arm.num_joints)]
            ee_pos = np.asarray(fake_pybullet.getLinkState(arm._id, names.index(SYNTH_LINK_EE))[0])
            q_end = robot.assemble_q(Q_served[0, -1], requests[0][2]["q_param"][0])
            fk_pos = robot.get_global_link_transform(SYNTH_LINK_EE, q_end)[:3, 3].double().cpu().numpy()
            fake_pybullet.disconnect()
        finally:
            if previous is None:
                _sys.modules.pop("pybullet", None)
            else:
                _sys.modules["pybullet"] = previous
        ee_err = float(np.linalg.norm(ee_pos - fk_pos))
        if not ee_err <= EXECUTE_TOL:
            raise AssertionError(f"executed plan: the fake's end-effector {ee_pos} is {ee_err:.3e} m from the FK "
                                 f"of the plan's last step {fk_pos}")
    print(f"[serving] retimed {len(retimed)} served plans (convert_plan_to_trajectory, synth7's velocity limits, 0.5 rad/s^2): "
          f"durations {[round(float(r[1][-1]), 3) for r in retimed]} s, endpoints within "
          f"{max(r[2] for r in retimed):.3e} rad (limit {RETIME_END_TOL}), |qd| up to "
          f"{max(r[3] for r in retimed):.4f} x the limits (limit {RETIME_VEL_FACTOR}); the first executed on the "
          f"port's fake PyBullet through FixedBaseRobot (synth7's URDF, {len(retimed[0][0])} waypoints): its "
          f"end-effector {np.round(ee_pos, 6).tolist()} is {ee_err:.3e} m from the card's FK of the plan's last "
          f"step (limit {EXECUTE_TOL} m)")

    # the native geometry library: built here, and the rasterizer bit for bit against numpy
    with timer.phase("native"):
        if not native.is_available():
            raise AssertionError("native: the geomcore library did not build (g++)")
        env = SyntheticSceneEnv(robot_name="panda", scene_type="tabletop", n_objects=5, width=160, height=160)
        env.setup_scene(10)
        env.reset_scene()
        got = env.get_observation()
        with mock.patch.object(native, "rasterize_native", lambda *a, **k: False):
            want = env.get_observation()
        for a, b in zip(got, want):
            if not np.array_equal(a, b):
                raise AssertionError("native: the C++ rasterizer differs from the numpy one")
    print(f"[serving] native: libgeomcore built from csrc/geomcore.cpp; a 160x160 tabletop observation "
          f"({int((got[1] >= 0).sum())} object pixels) bit-identical through the C++ and the numpy rasterizer")
    print("[serving] PhaseTimer(sync=True):\n" + "\n".join(f"[serving]   {line}" for line in timer.report().splitlines()))
    print(f"[serving] phase {time.perf_counter() - t_phase:.1f} s")
    return per_solve


SHARDED_COST_RTOL = 1e-6  # the sharded solver's mean_cost against the unsharded cost.mean()


def phase_sharded(dev):
    """bench.py's sharded solve (BENCH_MESH) on the port: a world of one on
    NCCL through parallel.distributed_init (a file:// store in a temporary
    directory, no TCP port), parallel.data_mesh(1), and
    bench.ShardedSolveBench at full width (the default flavour, B = 32 x 8
    goals, T = 50, synth7 at 100 points a link, every problem its own
    field: each step packs them into one stacked table of 32 slabs and
    runs solve_batch_stacked under make_sharded_solver). Checks: the
    step's Q and cost bit-identical (torch.equal) to the unsharded
    solve_batch_stacked of the same problems and tables, mean_cost within
    1e-6 relative of cost.mean(), K4 exactly 3 launches a step and K1-K3
    none, the plans finite, within the limits and pinned, K4 against
    plain at their final body points on the stacked table, no host sync
    in one step. Reports latency (best of 3) and plans/s (stream_map at
    inflight 4) beside the unsharded step's wall time (in turns), the
    gates, one step under torch.profiler (device time, ops, busy share,
    K4's device time against its bound), and K4 on the stacked table timed
    as the bench's record (2 coarse + 1 fine pass). Returns K4's record."""
    import tempfile

    import torch
    import torch.distributed as dist

    from grasptrajopt_tpu_torch import bench as pb
    from grasptrajopt_tpu_torch import parallel
    from grasptrajopt_tpu_torch.testing import make_synthetic_gto_robot

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as tmp:
        if not parallel.distributed_init(coordinator=f"file://{tmp}/store", device=dev):
            raise AssertionError("sharded: distributed_init started no process group")
        try:
            backend, world = dist.get_backend(), dist.get_world_size()
            if backend != "nccl" or world != 1:
                raise AssertionError(f"sharded: a {backend} group of {world}, expected NCCL at a world of one")
            mesh = parallel.data_mesh(1)
            robot = make_synthetic_gto_robot(device=dev, dtype=torch.float32, points_per_link=100)
            cfg = pb.FLAVOURS["default"]
            t0 = time.perf_counter()
            bench = pb.ShardedSolveBench(robot, cfg, mesh)
            bench.step()
            torch.cuda.synchronize(dev)
            setup_s = time.perf_counter() - t0
            reset_launch_counts()
            Q, cost, _ = bench.step()
            torch.cuda.synchronize(dev)
            counts = launch_counts()
            want = {"K1": 0, "K2": 0, "K3": 0, "K4": 3}
            if counts != want:
                raise AssertionError(f"sharded: launches {counts} a step, expected {want}")
            mean_cost = float(bench.metrics["mean_cost"])

            # the unsharded solve of the same problems on the same tables
            fields = bench.field.expand(cfg.batch, -1)

            def unsharded():
                return bench.solve_shard(bench.qc_opt, bench.X0, bench.params, fields, fields)

            Q_ref, cost_ref, _ = unsharded()
            if not (torch.equal(Q, Q_ref) and torch.equal(cost, cost_ref)):
                raise AssertionError(f"sharded: Q differs from the unsharded solve's by "
                                     f"{float((Q - Q_ref).abs().max()):.3e} rad, cost by "
                                     f"{float((cost - cost_ref).abs().max()):.3e}")
            mean_ref = float(cost_ref.mean())
            rel = abs(mean_cost - mean_ref) / abs(mean_ref)
            if not rel <= SHARDED_COST_RTOL:
                raise AssertionError(f"sharded: mean_cost {mean_cost!r} against cost.mean() {mean_ref!r} "
                                     f"({rel:.3e} relative)")
            check_plans("sharded", bench.full_q(Q), bench.qc, robot)
            tables, base = bench.planner.pack_stacked_fields(fields, fields)
            k4_err = check_plan_fields("sharded plans' final fields", bench.planner, tables, bench.full_q(Q),
                                       field_base=base)
            syncs = host_syncs(bench.step)
            if syncs:
                raise AssertionError(f"sharded: one step synchronizes the host: {syncs}")
            print(f"[sharded] {backend} process group of {world} (parallel.distributed_init, file:// store), "
                  f"data_mesh {bench.mesh}; {cfg.batch} problems x {cfg.goal_capacity} goals, T = {cfg.T}, "
                  f"{robot.num_surface_points} body points, every problem its own {robot.grid.size}-cell field: "
                  f"a stacked table of {tables.shape[0]} rows ({tables.numel() * tables.element_size() / 1e6:.1f} "
                  f"MB) a step; set-up (IK warm start, first step) {setup_s:.2f} s; launches a step {counts}; Q "
                  f"and cost bit-identical to the unsharded solve_batch_stacked; mean_cost {mean_cost!r} against "
                  f"cost.mean() {mean_ref!r} ({rel:.2e} relative, limit {SHARDED_COST_RTOL:g}); plans finite, "
                  f"within the limits and pinned; K4 vs plain at their final body points on the stacked table "
                  f"max |err| {k4_err:.3e}; host syncs in one step (set_sync_debug_mode): none")

            timed = pb.time_solves(bench, reps=3, pipe_reps=5)
            sharded_s, unsharded_s = [], []
            for _ in range(3):  # in turns, the unsharded step packing its table as the sharded one does
                for fn, times in ((bench.step, sharded_s), (unsharded, unsharded_s)):
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize(dev)
                    times.append(time.perf_counter() - t0)
            gates = bench.gates(timed["Q"])
            print(f"[sharded] latency {timed['latency_s'] * 1e3:.3f} ms (best of "
                  f"{[round(t * 1e3, 3) for t in timed['latency_runs_s']]} ms), sustained {timed['plans_per_s']:.3f} "
                  f"plans/s over 5 steps through stream_map at inflight {timed['inflight']}; in turns, sharded "
                  f"{[round(t * 1e3, 3) for t in sharded_s]} ms against unsharded "
                  f"{[round(t * 1e3, 3) for t in unsharded_s]} ms (best {min(sharded_s) / min(unsharded_s):.4f} "
                  f"x); gates {json.dumps(gates)} (reported, not gated)")

            # one step's device time, device activity only (a host trace of ~70k launches is slow)
            prof = device_profile(bench.step)
            device_ns, device_n, device_ms = prof["ns"], prof["n"], prof["device_ms"]
            k4_names = [k for k in device_ns if "field_lookup_kernel" in k]
            k4_profiled_ms = sum(device_ns[k] for k in k4_names) / 1e6
            if sum(device_n[k] for k in k4_names) != 3:
                raise AssertionError(f"sharded: the profiled step ran K4 {sum(device_n[k] for k in k4_names)} times")

            # K4 on the stacked table at the plans' final body points, as the bench's record: 2 coarse + 1 fine
            g, T = robot.grid, cfg.T
            row = (torch.arange(T, device=dev) >= T + bench.planner.standoff_offset).long()[:, None] * g.size
            row = row + base[:, None, None]
            t_pass = {}
            for stride in (1, bench.planner.coarse_stride):
                x, y, z = planner_points(robot, bench.full_q(Q), None, stride)
                t_pass[stride] = time_k4(tables, x, y, z, g.origin, g.shape, g.resolution, row)
                print(f"[sharded] K4 on the stacked table, stride {stride} {tuple(x.shape)}: "
                      + k4_time_line(t_pass[stride], x.numel()))
            fine, coarse = t_pass[1], t_pass[bench.planner.coarse_stride]
            rec = {key: fine[key] + 2 * coarse[key] for key in ("kernel", "plain", "index_select", "library", "bound")}
            by = fine["by"] if fine["by"] == coarse["by"] else "operations"
            busy = device_ms / (1e3 * timed["latency_s"])
            top = [[k[:60], device_n[k], round(v / 1e6, 3)] for k, v in device_ns.most_common(6)]
            print(f"[sharded] one step: wall {timed['latency_s'] * 1e3:.1f} ms (the best synchronized step), device "
                  f"{device_ms:.1f} ms in {sum(device_n.values())} device ops (torch.profiler, device activity), "
                  f"busy {100 * busy:.1f}%; K4 3 launches, {k4_profiled_ms:.4f} ms profiled against a bound of "
                  f"{rec['bound']:.4f} ms ({by}); top device ops {top}")
            print(f"[sharded] K4 a step on the stacked table (2 coarse + 1 fine, queued): kernel "
                  f"{rec['kernel']:.4f} ms, plain {rec['plain']:.4f} ms, index_select {rec['index_select']:.4f} ms, "
                  f"library (the faster gather) {rec['library']:.4f} ms, bound {rec['bound']:.4f} ms ({by}), "
                  f"{rec['bound'] / rec['kernel']:.1%} of the bound; phase {time.perf_counter() - t_phase:.1f} s")
        finally:
            dist.destroy_process_group()
    return {"launches": counts["K4"], "max_abs_err": k4_err, "ms": rec["kernel"], "plain_ms": rec["plain"],
            "bound_ms": rec["bound"], "bound_by": by, "library_ms": rec["library"]}


# phase 13: the SceneReplica drivers over a synth7 tree at full width
SCENEREPLICA_GRASPS = 32  # grasps an object in the tree (scenereplica_grasps: 8 turns x 4 heights)
SCENEREPLICA_SCENE = 10


class DriverRecorder:
    """Per run of a SceneReplica driver's `main`: the grasp pre-filter's
    calls (each an object that reached it) and keep masks, every
    signed-distance query (cloud, query points, result; those of the first
    object that reached the pre-filter kept) and each goal-set plan's call
    (planner, arguments, plan, synchronized wall). It wraps, in this
    script only, gto_planning's `filter_grasps_by_collision`,
    `DepthPointCloud.get_sdf` and `GTOPlanner.plan_goalset`, keeping
    references only (nothing is read to the host inside the driver's
    timed windows); `restore` undoes it."""

    def __init__(self):
        self._saved = []
        self.start()

    def start(self, profile_twin=False):
        """Opens a run. With `profile_twin`, the first plan whose start and
        goals equal an earlier plan's of the run (its twin) runs under
        torch.profiler (device activity) and host_syncs; `profiled` is
        then (its index, its twin's index)."""
        self.filters, self.sdf, self.first_sdf, self.plans = [], [], None, []
        self.profile_twin, self.profile, self.profiled = profile_twin, None, None

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def install(self):
        import torch

        import numpy as np

        from grasptrajopt_tpu_torch import gto_planning
        from grasptrajopt_tpu_torch.fields.depth_point_cloud import DepthPointCloud
        from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner

        rec = self

        def filter_grasps(orig):
            def run(*args, **kwargs):
                keep, ratios = orig(*args, **kwargs)
                rec.filters.append(keep)
                if rec.first_sdf is None:  # the first object: its two field builds and this query
                    rec.first_sdf = list(rec.sdf)
                rec.sdf = []
                return keep, ratios
            return run

        def get_sdf(orig):
            def run(cloud, query_points):
                out = orig(cloud, query_points)
                if rec.first_sdf is None:
                    rec.sdf.append((cloud, query_points, out))
                return out
            return run

        def twin_of(args):
            """Index of the earlier plan of this run with the same start and goals."""
            for i, r in enumerate(rec.plans):
                if all(np.array_equal(np.asarray(r["args"][k]), np.asarray(args[k])) for k in (0, 1)):
                    return i
            return None

        def plan_goalset(orig):
            def run(planner, *args, **kwargs):
                twin = twin_of(args) if rec.profile_twin and rec.profiled is None else None
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if twin is not None:
                    res, syncs = {}, {}

                    def go():
                        res["out"] = orig(planner, *args, **kwargs)
                    prof = device_profile(lambda: syncs.update(host_syncs(go)))
                    out, rec.profile, rec.profiled = res["out"], (prof, syncs), (len(rec.plans), twin)
                else:
                    out = orig(planner, *args, **kwargs)
                wall_ms = 1e3 * (time.perf_counter() - t0)
                rec.plans.append({"planner": planner, "args": args, "kwargs": kwargs, "Q": out[0],
                                  "wall_ms": wall_ms, "grid": planner.robot.grid})
                return out
            return run

        self._patch(gto_planning, "filter_grasps_by_collision", filter_grasps)
        self._patch(DepthPointCloud, "get_sdf", get_sdf)
        self._patch(GTOPlanner, "plan_goalset", plan_goalset)

    def restore(self):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved = []


def device_profile(fn) -> dict:
    """Device time (ms) and device operations of one call of `fn`, by
    torch.profiler with device activity only, summing the raw events (a
    host trace of a solve's launches, or key_averages over them, is
    slow); the top device operations by time."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    prof, _ = profiled(fn, [ProfilerActivity.CUDA])
    device_ns, device_n = collections.Counter(), collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            device_ns[e.name()] += e.duration_ns()
            device_n[e.name()] += 1
    return {"device_ms": sum(device_ns.values()) / 1e6, "ops": sum(device_n.values()), "n": device_n,
            "ns": device_ns, "top": [[k[:60], device_n[k], round(v / 1e6, 3)] for k, v in device_ns.most_common(6)]}


def check_result_file(name, path, scene_type, ndof) -> dict:
    """A driver's result file in the JAX schema (tests/test_drivers.py):
    the scene's orderings, each object's record with at least reward,
    plan, checking_time, ik_time and planning_time, each plan (ndof, T);
    it round-trips through aggregate_results. Returns the loaded file."""
    import numpy as np

    from grasptrajopt_tpu_torch.gto_planning import SCENE_KNOBS
    from grasptrajopt_tpu_torch.utils.results import aggregate_results, load_results

    results = load_results(path)
    if set(results) != {str(SCENEREPLICA_SCENE)}:
        raise AssertionError(f"{name}: scenes {sorted(results)}")
    orderings = results[str(SCENEREPLICA_SCENE)]
    if set(orderings) != set(SCENE_KNOBS[scene_type]["orderings"]):
        raise AssertionError(f"{name}: orderings {sorted(orderings)}")
    trials = 0
    for objects in orderings.values():
        for obj, r in objects.items():
            missing = {"reward", "plan", "checking_time", "ik_time", "planning_time"} - set(r)
            if missing:
                raise AssertionError(f"{name} {obj}: record lacks {sorted(missing)}")
            if r["plan"] is not None and np.asarray(r["plan"]).shape[0] != ndof:
                raise AssertionError(f"{name} {obj}: plan of shape {np.asarray(r['plan']).shape}")
            trials += 1
    if aggregate_results(load_results(path))["trials"] != trials:
        raise AssertionError(f"{name}: aggregate_results counts other trials than the file's {trials}")
    return results


def phase_scenereplica(dev):
    """The SceneReplica drivers (gto_planning, evaluate_plans, ik_checking:
    the port of examples/gto_planning.py and its replay and IK checker)
    through their `main(argv)` on the port's fake PyBullet, over a synth7
    tree (testing.make_scenereplica_tree in a temporary directory) at full
    width: synth7 at 100 points a link with its gripper, SCENEREPLICA_GRASPS
    grasps an object, the env's 640x480 window, goal capacity 64, the
    planner's and the IK screen's defaults (50 two-pass LM iterations; 8
    seeds x 50). Runs gto_planning on tabletop scene 10 (both orderings,
    2 objects) and on its shelf scene (2 objects, random order),
    evaluate_plans on each result file, ik_checking on scene 10. Checks:
    the result files in the JAX schema with at least 2 objects planned on
    the tabletop; every plan finite, within the limits and starting (its
    first two steps) at the qc the driver executed; K1 exactly 3 launches
    for each object that reaches the pre-filter and 1 for each replayed
    plan (ik_checking: 1 an object), K4 exactly the planner's
    linearisations (1 + 2 x 50 a plan), K2 / K3 none; K1 against plain at
    the first object's three launches, K4 against plain at the last
    tabletop plan's final body points; K1 timed at those three launches.
    Reports ms an object for checking, IK and planning, grasps kept and IK
    found (the goals each plan got, 0 where the driver planned nothing
    after its IK screen), rewards and the replay's collision verdicts, and
    the device time, ops and host syncs of the first tabletop plan whose
    start and goals repeat an earlier plan's, profiled in the run, with
    its busy share over the wall of that unprofiled twin. The simulator's
    waits are skipped: the fake has no physics to settle. Returns the
    phase's seconds."""
    import importlib
    import os
    import tempfile
    import types

    import numpy as np
    import torch

    from grasptrajopt_tpu_torch.envs import fake_pybullet

    fake_pybullet.install(force=True)
    from grasptrajopt_tpu_torch.envs import pybullet_api, scene_replica

    if pybullet_api.p is not fake_pybullet:
        importlib.reload(pybullet_api)
        importlib.reload(scene_replica)
    from grasptrajopt_tpu_torch import evaluate_plans, gto_planning, ik_checking
    from grasptrajopt_tpu_torch.gto_planning import SCENE_KNOBS
    from grasptrajopt_tpu_torch.testing import make_scenereplica_tree

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="scenereplica_")
    tree, outdir = os.path.join(tmp.name, "tree"), os.path.join(tmp.name, "results")
    make_scenereplica_tree(tree, SCENEREPLICA_SCENE, SCENEREPLICA_GRASPS)
    common = ["-r", "synth7", "--assets_dir", tree, "-s", str(SCENEREPLICA_SCENE), "--device", dev.type]
    rec = DriverRecorder()
    rec.install()
    # the simulator's waits (setup_scene's 2 s, the driver's 1 s an object)
    # let a physics engine settle; the fake has none to settle
    no_wait = types.SimpleNamespace(sleep=lambda s: None, time=time.time)
    waits = [(m, m.time) for m in (scene_replica, gto_planning)]
    for m, _ in waits:
        m.time = no_wait
    files, plans, first, profiled, profiled_at = {}, [], None, None, None
    try:
        for st in ("tabletop", "shelf"):
            # on the tabletop, the first plan that repeats an earlier one's
            # start and goals (one object, planned in both orderings) runs
            # under torch.profiler
            rec.start(profile_twin=st == "tabletop")
            reset_launch_counts()
            t0 = time.perf_counter()
            files[st] = gto_planning.main(common + ["-t", st, "--outdir", outdir, "--goal_capacity", "64"])
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = launch_counts()
            k4_want = sum(k4_per_solve(r["planner"]) for r in rec.plans)
            want = {"K1": 3 * len(rec.filters), "K2": 0, "K3": 0, "K4": k4_want}
            if counts != want:
                raise AssertionError(f"gto_planning {st}: launches {counts}, expected {want} "
                                     f"({len(rec.filters)} objects filtered, {len(rec.plans)} plans)")
            robot = rec.plans[0]["planner"].robot if rec.plans else None
            results = check_result_file(f"gto_planning {st}", files[st], st, 9)
            for i, r in enumerate(rec.plans):
                qc = torch.as_tensor(np.asarray(r["args"][0]), dtype=r["planner"].robot.dtype, device=dev)
                check_plans(f"gto_planning {st} plan {i}", torch.as_tensor(r["Q"], device=dev).T, qc,
                            r["planner"].robot)
            if first is None:
                first = [(cloud, cloud._queries(q), out) for cloud, q, out in rec.first_sdf]
            if st == "tabletop":
                if rec.profiled is None:
                    raise AssertionError(f"gto_planning tabletop: none of its {len(rec.plans)} plans repeats an "
                                         "earlier plan's start and goals, so none was profiled beside a twin")
                profiled_at = i, j = rec.profiled
                profiled = (rec.plans[i], rec.profile, rec.plans[j])
            plans += [dict(r, scene_type=st) for r in rec.plans]
            recs = [(o, n, r) for ords in results.values() for o, objs in ords.items() for n, r in objs.items()]
            planned = [r for _, _, r in recs if r["plan"] is not None]
            if len(planned) != len(rec.plans):
                raise AssertionError(f"gto_planning {st}: {len(planned)} plans in the file, {len(rec.plans)} made")
            if st == "tabletop" and len(planned) < 2:
                raise AssertionError(f"gto_planning tabletop: {len(planned)} objects planned")
            # IK found, from what the driver did: the goals it handed each
            # plan (in the file's order), 0 where it screened and planned nothing
            goals = iter(len(r["args"][1]) for r in rec.plans)
            found = [next(goals) if r["plan"] is not None else 0 for _, _, r in recs if r["ik_time"] is not None]

            # the profiled plan's planning time carries the profiler's cost:
            # it is left out of the means and printed on its own below
            skip = planned[rec.profiled[0]] if rec.profiled is not None else None

            def ms(key):
                vals = [r[key] for _, _, r in recs
                        if r[key] is not None and not (key == "planning_time" and r is skip)]
                return f"{1e3 * statistics.mean(vals):.1f}" if vals else "-"
            print(f"[scenereplica] gto_planning {st} scene {SCENEREPLICA_SCENE}: {len(recs)} trials "
                  f"({', '.join(f'{o} {n}' for o, n, _ in recs)}), {len(planned)} planned; grasps kept "
                  f"{[int(k.sum()) for k in rec.filters]} of {SCENEREPLICA_GRASPS}, IK found {found}; rewards "
                  f"{[r['reward'] for _, _, r in recs]} (the fake has no grasp rule: reported, not gated); "
                  f"ms an object: checking {ms('checking_time')}, IK {ms('ik_time')}, planning "
                  f"{ms('planning_time')} (each {[round(1e3 * r['planning_time'], 1) for _, _, r in recs if r['planning_time']]}"
                  f"{'' if skip is None else f'; the profiled plan, index {rec.profiled[0]}, left out of the mean'}); "
                  f"launches {counts} (as expected); plans finite, within the limits, starting at the executed "
                  f"qc; result file {files[st]} in the JAX schema; run wall {wall:.1f} s")

        for st in ("tabletop", "shelf"):
            loaded = check_result_file(f"evaluate_plans {st}", files[st], st, 9)
            replayed = sum(r["plan"] is not None for ords in loaded.values() for objs in ords.values()
                           for r in objs.values())
            reset_launch_counts()
            t0 = time.perf_counter()
            agg = evaluate_plans.main(common + ["-t", st, "-f", files[st]])
            torch.cuda.synchronize()
            counts = launch_counts()
            want = {"K1": replayed, "K2": 0, "K3": 0, "K4": 0}
            if counts != want:
                raise AssertionError(f"evaluate_plans {st}: launches {counts}, expected {want}")
            print(f"[scenereplica] evaluate_plans {st}: {replayed} plans replayed, collisions "
                  f"{agg['total_collision']} {json.dumps(agg['collision_by_object'])}, success {agg['success']} "
                  f"of {agg['trials']}; launches {counts} (as expected); wall {time.perf_counter() - t0:.1f} s")

        rec.start()
        reset_launch_counts()
        t0 = time.perf_counter()
        screened = ik_checking.main(common + ["-t", "tabletop"])
        torch.cuda.synchronize()
        counts = launch_counts()
        want = {"K1": len(screened), "K2": 0, "K3": 0, "K4": 0}
        if counts != want:
            raise AssertionError(f"ik_checking: launches {counts}, expected {want}")
        print(f"[scenereplica] ik_checking tabletop: found "
              f"{ {o: f'{int(f.sum())}/{f.size} in {1e3 * s:.1f} ms' for o, (f, s) in screened.items()} }; "
              f"launches {counts} (as expected); wall {time.perf_counter() - t0:.1f} s")
    finally:
        rec.restore()
        for m, t in waits:
            m.time = t

    # K1 against plain at the first object's launches (two field builds, the pre-filter)
    checked = check_k1_records(first)
    print("[scenereplica] K1 vs plain at the first object's launches (M queries x N cloud points, max |d2 "
          "err|): " + ", ".join(f"{m} x {n}: {e:.3e}" for m, n, e in checked) + f" (tolerance {FIELD_TOL:g}); "
          "fields and inside verdicts as plain's")
    for cloud, q, _ in first:
        km, qm, pm, bm, by, (tile_m, S) = time_k1(cloud, q)
        print(f"[scenereplica] K1 B=1 M={q.shape[0]} N={cloud.points_padded.shape[0]} (tile_m {tile_m}, S {S}): "
              f"median kernel {km:.4f} ms ({bm / km:.1%} of the bound), queued {qm:.4f} ms ({bm / qm:.1%}), "
              f"plain {pm:.4f} ms, bound {bm:.4f} ms ({by})")
    del first
    # K4 against plain at the last tabletop plan's final body points
    last = [r for r in plans if r["scene_type"] == "tabletop"][-1]
    planner, (qc, RTs, sdf_all, sdf_obs, base) = last["planner"], last["args"][:5]
    planner.robot.grid = last["grid"]  # the grid of that plan's object
    table = planner.field_table(planner._tensor(sdf_all), planner._tensor(sdf_obs))
    Q_full = torch.as_tensor(last["Q"], device=dev).T[None].contiguous()
    err = check_plan_fields("scenereplica plan", planner, table, Q_full, planner._tensor(base)[None])
    print(f"[scenereplica] K4 vs plain at the last tabletop plan's final body points "
          f"({tuple(Q_full.shape)} on its {planner.robot.grid.size}-cell grid): max |err| {err:.3e} "
          f"(tolerance {LOOKUP_TOL:g} x (1 + |plain|))")

    # the profiled plan beside its unprofiled twin (the same start and goals,
    # planned earlier in the run)
    (p_rec, (prof, syncs), twin) = profiled
    (p_i, twin_i) = profiled_at
    k4_n = sum(n for k, n in prof["n"].items() if "field_lookup_kernel" in k)
    if k4_n != k4_per_solve(p_rec["planner"]):
        raise AssertionError(f"scenereplica: the profiled plan ran K4 {k4_n} times")
    print(f"[scenereplica] one plan under torch.profiler (the tabletop's plan {p_i}, twin of its plan {twin_i}: "
          f"{len(p_rec['args'][1])} goals, "
          f"capacity {p_rec['kwargs']['goal_capacity']}): device {prof['device_ms']:.1f} ms in {prof['ops']} device ops "
          f"(device activity; K4 {k4_n} launches), profiled wall {p_rec['wall_ms']:.1f} ms; its unprofiled twin "
          f"{twin['wall_ms']:.1f} ms (plans bit-identical: {np.array_equal(twin['Q'], p_rec['Q'])}), busy "
          f"{prof['device_ms'] / twin['wall_ms']:.1%}; top device ops {json.dumps(prof['top'])}; host syncs "
          f"{sync_sites(syncs)}")
    del profiled, twin, p_rec
    del plans, last, table
    tmp.cleanup()
    seconds = time.perf_counter() - t_phase
    print(f"[scenereplica] phase {seconds:.1f} s")
    return seconds


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    import numpy as np

    from grasptrajopt_tpu_torch.testing import make_synthetic_gto_robot

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    # the solver is specified at full float32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}; nvidia-smi: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}; host {host_cpu()}")

    def lap(phase):
        """The run's clock after each phase: where the time limit goes."""
        print(f"[time] {phase} done at {time.perf_counter() - t_start:.1f} s", flush=True)

    phase_build()
    lap("build")
    # host_syncs must see a sync where there is one
    if not host_syncs(lambda: torch.ones(1, device=dev).item()):
        raise AssertionError("host_syncs found no sync in a .item() of a CUDA tensor")
    grid_pts = make_synthetic_gto_robot(device=dev, points_per_link=1).grid.grid_points(np.float32)
    max_err, k_ms, p_ms, b_ms, b_by = phase_kernel_vs_plain(grid_pts, dev)
    lap("K1 vs plain")
    near = phase_nearest_vs_plain(grid_pts, dev)
    lap("K2 / K3 vs plain")
    launches, slice_k4, path, obs, out = phase_slice(dev)
    lap("slice")
    ik_k4, ik_err = phase_ik_collision(path, obs, out, dev)
    lap("IK collision screen")
    k2_launches, k3_launches = phase_pergoal(path, obs, out, dev)
    lap("per-goal tiers")
    del path, obs, out
    k4, k4_launches, k5 = phase_bench(dev)
    lap("bench solve")
    phase_closed_loop(dev)
    lap("closed loop")
    occ = phase_mobile(dev)
    lap("mobile")
    phase_builder(dev)
    lap("builder")
    serving_k4 = phase_serving(dev)
    lap("serving")
    sharded = phase_sharded(dev)
    lap("sharded")
    scenereplica_s = phase_scenereplica(dev)
    lap("SceneReplica drivers")
    print(f"[done] K4 launches on its paths: bench solve {k4_launches['default']} (float32) and "
          f"{k4_launches['bf16']} (bf16), the e2e slice {slice_k4}, the IK collision screen {ik_k4} "
          f"(max |err| there {ik_err:.3e}), a served solve {serving_k4}, a sharded step {sharded['launches']}")
    print(f"[done] the SceneReplica drivers {scenereplica_s:.1f} s; {time.perf_counter() - t_start:.1f} s")

    def record(name, source, replaces, launches, err, ms, plain_ms, bound, bound_by, library_ms):
        return {
            "name": name, "route": "cuda", "source": f"grasptrajopt_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms,
        }

    def k4_fields(r):
        return r["max_abs_err"], r["ms"], r["plain_ms"], r["bound_ms"], r["bound_by"], r["library_ms"]

    # K1-K3 have no library call: torch.cdist in its exact mode would
    # materialize every (query, point) distance
    print(smi)
    print(json.dumps({"kernels": [
        record("K1 min_d2 (exact-fp32 batched min squared distance)", "min_d2.cu",
               "grasptrajopt_tpu/ops/nn.py:87", launches, max_err, k_ms, p_ms, b_ms, b_by, None),
        record("K2 nearest (nearest point, index and normal)", "nearest.cu",
               "grasptrajopt_tpu/ops/nn.py:296", k2_launches, *near["K2"], None),
        record("K3 min_sqdist (nearest.cu in its index-only mode: d2 and argmin under a mask)", "nearest.cu",
               "grasptrajopt_tpu/ops/nn.py:420", k3_launches, *near["K3"], None),
        record("K3 min_sqdist at the mobile occupancy builds (tabletop and shelf placements; ms queued)",
               "nearest.cu", "grasptrajopt_tpu/ops/nn.py:420", occ["launches"], occ["err"], occ["ms"],
               occ["plain_ms"], occ["bound_ms"], occ["bound_by"], None),
        record("K4 field_lookup (packed-row trilinear lookup with its closed-form gradient)", "field_lookup.cu",
               "tools/probe_vmem_gather.py:52", k4_launches["default"], *k4_fields(k4["float32"])),
        record("K4 field_lookup, bf16-row mode (one 16-byte row a point, upcast to float32)", "field_lookup.cu",
               "tools/probe_vmem_gather.py:52", k4_launches["bf16"], *k4_fields(k4["bf16"])),
        record("K4 field_lookup on per-problem stacked tables (the sharded bench step: 32 slabs, 196 MB)",
               "field_lookup.cu", "tools/probe_vmem_gather.py:52", sharded["launches"], *k4_fields(sharded)),
        record("K5 block_tridiag (the KKT's block Thomas solve at (2,048, 48, 7), float32; ms queued, plain ms "
               "its device ops summed; max_abs_err relative to max |x|)", "block_tridiag.cu",
               "none: grasptrajopt_tpu/ops/block_tridiag.py:block_tridiag_solve is a lax.scan",
               k4_launches["default K5"], k5["max_rel_err"], k5["ms"], k5["plain_ms"], k5["bound_ms"],
               k5["bound_by"], None),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
