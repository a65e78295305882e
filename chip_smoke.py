#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (grasptrajopt_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

  1. device: a CUDA device is required (there is no CPU path); prints the
     card's name and power limit as nvidia-smi reports them;
  2. build: compiles the kernels (csrc/min_d2.cu: K1; csrc/nearest.cu: K2
     and K3; csrc/field_lookup.cu: K4) with nvcc for sm_90a from the
     sources in this checkout, one nvcc per source, all started together,
     and prints nvcc's register and shared-memory report;
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
     exact duplicate points, where the first index must win. d2 within
     1e-5 m^2 below 10 m^2 and 1e-6 relative above; the kernel's index
     points at a valid row whose float64 distance is as near (same
     tolerance) as the plain minimum's, so a near-tie the fused
     multiply-adds break the other way passes; the returned point and
     normal are that row's, bit for bit. Median CUDA-event times of both;
  5. slice: the perception-to-plan path (16 objects of the synthetic
     tabletop scenes 10/36/48/65 at 160x160, 32 grasps each, the synthetic
     7-DoF arm with 1,000 surface points on its 95,760-cell grid, IK 50
     iterations, plan T = 50 with 3 iterations, coarse 2+1, final_trust),
     once to warm up and once counted: K1 must launch exactly 3 times (two
     field passes and the grasp pre-filter) and K4 3 times (the plan's
     coarse, coarse and fine linearisations), both fields and the
     pre-filter must agree with the plain version on the clouds the card
     produced, the plan must be finite, within the joint limits and
     pinned at its first two steps, and K4 must agree with its plain
     version at the plan's body points as the planner passes them (the
     x / y / z views of one (B, T, P, 3) tensor, the per-object row bases
     of the stacked table) at the fine and the coarse stride;
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
     starts with the multistart rescue. First K4 against its plain version
     on the same CUDA tensors: the bench's fine and coarse passes (1.6 M
     and 0.8 M body points of the warm starts) both as the AoS views the
     Jacobian pass gives (every launch of the default solve) and as the
     SoA tensors of the two-pass value passes, the slice's stacked table
     (16 objects, 98 MB), the TPU probe's shape (145,152 rows, 1.92 M
     points in the cells its uniform and coherent +-64 offsets name), and
     ragged, outside, on-face and strided (AoS) points; each output within
     1e-5 x (1 + |plain|), zero gradient outside the grid; the median
     device time a call of the kernel, the plain version and the two
     library gathers of the same rows (torch.index_select and table[rows];
     the faster is the yardstick), each call's launches queued back to
     back (`queued_ms`). A report of the IK warm start (single seed and
     multistart reach on the bench's goals). Then each flavour, warmed up,
     timed (latency: best of 3 synchronized solves; sustained plans/s: 5
     back-to-back solves, one synchronize) and counted once: K4 exactly 3
     launches a solve in the
     default flavour (T = 50, single pass, coarse 2+1, final_trust), 7 in
     the two-pass flavour (1 + 3 x 2) and 3 in the long-horizon flavour
     (T = 200, cyclic reduction), K1-K3 none; the plans finite, within the
     limits, pinned, their final field values equal to plain K4's at the
     AoS views of their body points (fine and, with a coarse phase, coarse
     stride); the
     quality gates reported, not gated; cyclic reduction against the
     Thomas solve at (32, 198, 7, 7) to 1e-4 relative;
  8. closed loop (grasptrajopt_tpu_torch.synthetic_eval, the harness a
     user runs): the synthetic arm and its gripper, one object a trial at
     full width (160x160, 32 grasps, 1,000 body points, the bench's
     planner flavour): a warm-up trial, then tabletop scene 10 (nearest
     first, 5 objects) and shelf scene 10 (random order, 3 objects, two
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
  9. result: the nvidia-smi line, one JSON line of kernel records (with
     each kernel's roofline bound and, for K4, the library call's time),
     and the last line {"ok": true, "device": {...}}.
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
KERNEL_SOURCES = ("min_d2", "nearest", "field_lookup")
# the H100 SXM's peaks (NVIDIA's data sheet, at 700 W): device memory, and the
# FP32 rate of 67 TFLOP/s as lane instructions (a fused multiply-add, 2
# flops, issues once)
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 3.35e13
# the least K1's function needs a (query, point) pair: three subtracts,
# three multiply(-add)s (the penalty the first one's addend) and the min
K1_INSTR_PER_PAIR = 7


def bound_ms(nbytes: float, instructions: float):
    """(ms, "bytes" or "operations"): the least time the card could take
    for work that moves `nbytes` (each input read once, each output written
    once) and issues `instructions` FP32 lane instructions."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, instructions / FP32_INSTR_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


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


def device_kernels(fn) -> list:
    """[(name, device ms)] of the device kernels of one call of `fn`, by
    torch.profiler: which library kernel a yardstick runs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key[:120], round(e.self_device_time_total / 1e3, 4))
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from grasptrajopt_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        results = list(pool.map(lambda n: cuda_build.build(n, force=True), KERNEL_SOURCES))
    print(f"[build] {len(results)} sources in {time.perf_counter() - t0:.1f} s")
    for res in results:
        print(f"[build] {' '.join(res.command)}")
        print("[build] nvcc -Xptxas -v report:")
        for line in res.log.strip().splitlines():
            print(f"[build]   {line}")


def k1_bound(B, M, N, q_numel):
    """(ms, by) of one K1 launch: each input read once (queries, the
    (B, N, 4) rows), the (B, M) output written once, and K1_INSTR_PER_PAIR
    FP32 instructions for each of the B x M x N pairs."""
    return bound_ms(4 * (q_numel + 4 * B * N + B * M), K1_INSTR_PER_PAIR * B * M * N)


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


def check_nearest(name, q, rT, normals, got, want):
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
    C, _, N = rT.shape
    M = d2k.shape[1]
    if bool(((idxk < 0) | (idxk >= N)).any()):
        raise AssertionError(f"{name}: index out of range")
    qb = (q if q.dim() == 3 else q[None]).double()

    def row_d2(idx):  # float64 distance (plus penalty) of each query to row idx
        rows = torch.gather(rT, 2, idx.long()[:, None, :].expand(C, 4, M)).double()
        return ((qb - rows[:, :3].transpose(1, 2)) ** 2).sum(dim=-1) + rows[:, 3]

    dk, dp = row_d2(idxk), row_d2(idxp)
    gap = (dk - dp).abs()
    if bool((gap > d2_tolerance(dp)).any()):
        raise AssertionError(f"{name}: the kernel's nearest row is {float(gap.max()):.3e} m^2 farther than plain's")
    if len(got) == 4:
        pt = torch.gather(rT[:, :3], 2, idxk.long()[:, None, :].expand(C, 3, M)).transpose(1, 2)
        nm = torch.gather(normals, 1, idxk.long()[..., None].expand(C, M, 3))
        if not (torch.equal(got[2], pt) and torch.equal(got[3], nm)):
            raise AssertionError(f"{name}: point / normal are not the rows of the kernel's index")
    small = want64 < 10.0
    return float(err[small].max()) if bool(small.any()) else 0.0


def phase_nearest_vs_plain(grid_pts, dev, m_tier: int = 32 * 50 * 1000):
    """K2 and K3 against the plain version; returns {"K2": (max |d2 err|,
    kernel ms, plain ms, bound ms, bound_by), "K3": (...)}, the times
    summed over each mode's exact-tier launch shapes. m_tier: one
    object's queries in the exact tier (goal slots x T x body points)."""
    import numpy as np
    import torch

    from grasptrajopt_tpu_torch.fields.scene_points import PAD_COORD
    from grasptrajopt_tpu_torch.ops import nn

    rng = np.random.default_rng(1)
    lo, hi = grid_pts.min(axis=0), grid_pts.max(axis=0)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def ref_set(C, N, pad=0.1, valid=None):
        """(rT, normals): C sets of N points, the last `pad` share of the
        rows PAD_COORD (a fixed-capacity scene set), and an optional
        validity mask with that share of valid rows."""
        pts = rng.uniform(lo, hi, size=(C, N, 3))
        pts[:, N - int(pad * N) :] = PAD_COORD
        nrm = rng.normal(size=(C, N, 3))
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        mask = None if valid is None else f32(rng.uniform(size=(C, N)) < valid).bool()
        return nn._pack_refT(f32(pts), mask), f32(nrm)

    def queries(C, M):
        return f32(rng.uniform(lo - 0.2, hi + 0.2, size=(C, M, 3)))

    big_q = queries(16, m_tier)
    cases = []  # (name, mode, q, rT, normals, timed)
    obst = ref_set(16, 4096)
    cases.append(("K2 exact tier obstacle pass C=16 M=1.6M N=4096", "K2", big_q, *obst, True))
    cases.append(("K2 exact tier target pass C=16 M=1.6M N=1024", "K2", big_q, *ref_set(16, 1024), True))
    cases.append(("K2 one-object call C=1 M=1.6M N=4096", "K2", big_q[:1].contiguous(), *ref_set(1, 4096), False))
    for C, M, N in ((3, 1, 1), (2, 1025, 4097), (5, 1000, 1000), (2, 2049, 2048)):
        cases.append((f"K2 ragged C={C} M={M} N={N}", "K2", queries(C, M), *ref_set(C, N, pad=0.0), False))
    shared_q = f32(rng.uniform(lo, hi, size=(777, 3)))
    cases.append(("K2 shared queries C=3 M=777 N=3000", "K2", shared_q, *ref_set(3, 3000), False))
    all_pad = ref_set(2, 2100)
    all_pad[0][1, :3] = PAD_COORD  # set 1: every row is padding
    cases.append(("K2 all-PAD_COORD set C=2 M=3000 N=2100", "K2", queries(2, 3000), *all_pad, False))
    cases.append(("K3 exact tier obstacle pass, masked C=16 M=1.6M N=4096", "K3", big_q,
                  ref_set(16, 4096, valid=0.9)[0], None, True))
    invalid, _ = ref_set(4, 3000, pad=0.0, valid=0.6)
    invalid[2, 3] = nn.PENALTY_BIG  # set 2: every point invalid
    cases.append(("K3 masked, one all-invalid set C=4 M=5000 N=3000", "K3", queries(4, 5000), invalid, None, False))
    base = rng.uniform(lo, hi, size=(2, 3000, 3))
    dup = nn._pack_refT(f32(np.concatenate([base, base], axis=1)))  # row n and n + 3000 coincide
    dup_n = f32(np.concatenate([np.tile([0.0, 0.0, 1.0], (2, 3000, 1)), np.tile([0.0, 0.0, -1.0], (2, 3000, 1))], axis=1))
    dup_q = f32(np.concatenate([base + 1e-3, rng.uniform(lo, hi, size=(2, 1000, 3))], axis=1))
    cases.append(("K2 exact duplicates C=2 M=4000 N=6000", "K2", dup_q, dup, dup_n, False))

    out = {"K2": [0.0, 0.0, 0.0, 0.0, None], "K3": [0.0, 0.0, 0.0, 0.0, None]}
    for name, mode, q, rT, normals, timed in cases:
        got = nn.nearest_batched(q, rT, normals)
        want = nn.nearest_batched_reference(q, rT, normals)
        torch.cuda.synchronize()
        err = check_nearest(name, q, rT, normals, got, want)
        if rT is all_pad[0] and not bool((got[1][1] == 0).all()):
            raise AssertionError("K2: on an all-PAD_COORD set the first row must win")
        if rT is invalid and not (bool((got[0][2] >= 1e38).all()) and bool((got[1][2] == 0).all())):
            raise AssertionError("K3: an all-invalid set must give the penalty and index 0")
        if rT is dup and not (bool((got[1] < 3000).all()) and bool((got[3][..., 2] == 1.0).all())):
            raise AssertionError("K2: of two coincident points the first index must win")
        rec = out[mode]
        rec[0] = max(rec[0], err)
        line = f"[nearest] {name}: max |d2 err| {err:.3e} m^2 (below 10 m^2)"
        if timed:
            kernel_t, plain_t = [], []
            for _ in range(3):  # in turns: plain, kernel
                plain_t += cuda_ms(lambda: nn.nearest_batched_reference(q, rT, normals), 1)
                kernel_t += cuda_ms(lambda: nn.nearest_batched(q, rT, normals), 1)
            km, pm = statistics.median(kernel_t), statistics.median(plain_t)
            pairs = q.shape[-2] * rT.shape[0] * rT.shape[2]
            # about 10 FP32 instructions a pair (the squared distance with
            # its penalty, the compare and two selects that carry the
            # index); outputs d2 and index, with normals also the point
            # and its normal
            n_out = q.shape[-2] * rT.shape[0] * (2 if normals is None else 8)
            n_in = q.numel() + rT.numel() + (0 if normals is None else normals.numel())
            bm, rec[4] = bound_ms(4 * (n_in + n_out), 10 * pairs)
            rec[1], rec[2], rec[3] = rec[1] + km, rec[2] + pm, rec[3] + bm
            line += (f"; median kernel {km:.4f} ms, plain {pm:.4f} ms, bound {bm:.4f} ms; "
                     f"{pairs:.3e} pairs, {pairs / km * 1e3:.3e} pairs/s")
        print(line)
        del got, want
    print(f"[nearest] K2 max |d2 err| {out['K2'][0]:.3e}, K3 {out['K3'][0]:.3e} m^2 over {len(cases)} cases "
          f"(tolerance {NEAR_TOL:g} m^2 below 10 m^2, {NEAR_RTOL:g} relative above)")
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
    import torch

    from grasptrajopt_tpu_torch.e2e import (
        PerceptionToPlan, SliceConfig, collect_observations, reach_fractions,
    )
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
          f"grid {robot.grid.shape} = {robot.grid.size} cells")
    path.run(obs)  # warm-up: library handles, allocator

    nn.min_d2_launches = interp.field_lookup_launches = 0
    out = path.run(obs)
    launches, k4 = nn.min_d2_launches, interp.field_lookup_launches
    if (launches, k4) != (3, 3):
        raise AssertionError(f"the slice launched K1 {launches} and K4 {k4} times, expected 3 and 3")

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

    Q, cost = out["Q"], out["cost"]
    B, T = cfg.batch, cfg.T
    if tuple(Q.shape) != (B, T, robot.num_opt_joints):
        raise AssertionError(f"Q has shape {tuple(Q.shape)}")
    Q_full = robot.assemble_q(Q, robot.extract_parameter_dimensions(path.qc))
    check_plans("the plan", Q_full, path.qc, robot)
    if not torch.isfinite(cost).all():
        raise AssertionError(f"non-finite plan cost: {cost.tolist()}")
    if not (torch.isfinite(two.f_all).all() and torch.isfinite(two.f_obs).all()):
        raise AssertionError("non-finite cost field")
    plan_err = check_plan_fields("slice plan final fields", path.planner, out["tables"], Q_full,
                                 x["base_position"].expand(B, 3)[:, None, :], out["field_base"])

    reach = reach_fractions(robot, path.link_ee, Q_full, x["tf_goal"], out["goal_mask"])
    ms = {k: 1e3 * v / B for k, v in out["seconds"].items()}
    print(f"[slice] K1 launches {launches}, K4 {k4}; Q {tuple(Q.shape)} finite, within limits; "
          f"cost median {float(cost.median()):.4f}, max {float(cost.max()):.4f}; final fields on the "
          f"stacked table vs plain K4 (fine and coarse passes, AoS views): max |err| {plan_err:.3e}")
    print(f"[slice] kept grasps {int(out['keep'].sum())}/{out['keep'].numel()}, "
          f"IK found {int(out['found'].sum())}/{out['found'].numel()}, "
          f"goal slots {int(out['goal_mask'].sum())}")
    print(f"[slice] ms per object: fields {ms['fields']:.3f}, IK {ms['ik']:.3f}, "
          f"plan {ms['plan']:.3f} (host clock around synchronized phases, batch {B})")
    print(f"[slice] reach: {json.dumps(reach)} (reported, not gated)")
    print(f"[slice] peak device memory {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    return launches, path, obs, out


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
    rT = nn._pack_refT(sets["scene_points"])
    err = check_nearest(
        "exact tier final obstacle distances", pts, rT, sets["scene_normals"],
        nn.nearest_batched(pts, rT, sets["scene_normals"]),
        nn.nearest_batched_reference(pts, rT, sets["scene_normals"]),
    )
    del pts, rT
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


def check_plan_fields(name, planner, table, Q_full, base_position=None, field_base=None):
    """K4 against plain at the body points of plans Q_full (B, T, ndof), in
    the layout and with the row bases the planner gives it (the phase slab,
    plus each problem's field_base on a stacked table), at the fine stride
    and, where the planner has a coarse phase, the coarse one; returns the
    max |err|."""
    import torch

    from grasptrajopt_tpu_torch.ops import interp

    g = planner.robot.grid
    T = Q_full.shape[-2]
    row = (torch.arange(T, device=Q_full.device) >= T + planner.standoff_offset).long()[:, None] * g.size
    if field_base is not None:
        row = row + field_base[:, None, None]
    err = 0.0
    for stride in sorted({1, planner.coarse_stride if planner.coarse_iterations else 1}):
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


def lookup_bound(rows, n_points, n_bases):
    """K4's bound for one launch: 12 B of coordinates in and 16 B of value
    and gradient out a point, a 4-byte row base per (problem, step), the
    32-byte corner rows this launch touches once each; about 50 FP32
    instructions a point."""
    import torch

    touched = int(torch.unique(rows).numel())
    return bound_ms(28 * n_points + 4 * n_bases + 32 * touched, 50 * n_points)


def phase_field_lookup_vs_plain(dev, bench):
    """K4 against its plain version on the same CUDA tensors: the bench's
    fine and coarse passes (the shared table, body points of the warm
    starts), the slice's stacked table, the probe's shapes, and ragged,
    outside, on-face and strided input. Returns the K4 record of the main
    path's three launches a solve (two coarse, one fine): max |err|,
    kernel / plain / library / bound ms, bound_by."""
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
    cases += [
        ("ragged 3 x 7 x 11, AoS views (stride 3), 0.3 m beyond the grid", bench.table,
         (ragged_aos[..., 0], ragged_aos[..., 1], ragged_aos[..., 2]), g.origin, g.shape, g.resolution,
         phase[:7], None),
        (f"points on cell faces {tuple(face.shape[:-1])}", bench.table, (face[..., 0], face[..., 1], face[..., 2]),
         g.origin, g.shape, g.resolution, phase, None),
    ]

    max_err, rec = 0.0, {}
    for name, table, (x, y, z), origin, shape, res, row, timed in cases:
        got = interp.field_lookup_packed_soa_grad(table, x, y, z, origin, shape, res, row_offset=row)
        want = interp.field_lookup_packed_soa_grad_reference(table, x, y, z, origin, shape, res, row_offset=row)
        torch.cuda.synchronize()
        err = check_lookup(f"K4 {name}", got, want)
        max_err = max(max_err, err)
        line = f"[lookup] {name}: max |err| {err:.3e}"
        if name.startswith("ragged"):
            ux = (x.double() - origin[0]) / res
            outside = (ux < 0) | (ux > shape[0] - 1)
            if not (bool(outside.any()) and bool((got[1][outside] == 0).all())):
                raise AssertionError("K4: the x gradient must be zero outside the grid along x")
            line += f"; {int(outside.sum())} points outside along x, zero x gradient there"
        if timed:
            rows = lookup_rows(x, y, z, origin, shape, res, row)
            n_bases = interp._row_base(row, tuple(x.shape), dev)[0].numel()
            kernel_t, plain_t, sel_t, idx_t = [], [], [], []
            for _ in range(5):  # in turns: plain, kernel, the two library gathers
                plain_t.append(queued_ms(lambda: interp.field_lookup_packed_soa_grad_reference(
                    table, x, y, z, origin, shape, res, row_offset=row)))
                kernel_t.append(queued_ms(lambda: interp.field_lookup_packed_soa_grad(
                    table, x, y, z, origin, shape, res, row_offset=row)))
                sel_t.append(queued_ms(lambda: torch.index_select(table, 0, rows)))
                idx_t.append(queued_ms(lambda: table[rows]))
            km, pm, sm, im = (statistics.median(t) for t in (kernel_t, plain_t, sel_t, idx_t))
            if timed == "fine":
                print(f"[lookup] device kernels of one library gather: index_select "
                      f"{device_kernels(lambda: torch.index_select(table, 0, rows))}, "
                      f"table[rows] {device_kernels(lambda: table[rows])}")
            lone = statistics.median(cuda_ms(lambda: interp.field_lookup_packed_soa_grad(
                table, x, y, z, origin, shape, res, row_offset=row), 5))
            bm, by = lookup_bound(rows, x.numel(), n_bases)
            rec[timed] = (km, pm, min(sm, im), bm, by)
            line += (f"; median device time a call, queued: kernel {km:.4f} ms, plain {pm:.4f} ms, "
                     f"index_select {sm:.4f} ms, table[rows] {im:.4f} ms; bound {bm:.4f} ms ({by}); "
                     f"{x.numel() / km * 1e3:.3e} points/s; a lone call {lone:.4f} ms (CUDA events, with the "
                     "host's launch gaps)")
        print(line)
        del got, want

    def solve_record(f, c):  # a default solve's three launches: 2 coarse + 1 fine
        return tuple(a + 2 * b for a, b in zip(f[:4], c[:4])) + (f[4],)

    ms, plain_ms, library_ms, bound, bound_by = solve_record(rec["fine"], rec["coarse"])
    soa = solve_record(rec["fine SoA"], rec["coarse SoA"])
    out = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound, "bound_by": bound_by}
    print(f"[lookup] K4 max |err| {max_err:.3e} over {len(cases)} cases (tolerance {LOOKUP_TOL:g} x (1 + |plain|)); "
          f"a default solve's three launches (2 coarse + fine, AoS views as the planner passes them): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (the faster of index_select and table[rows]) "
          f"{library_ms:.4f} ms, bound {bound:.4f} ms; the same passes on SoA tensors: kernel {soa[0]:.4f} ms, "
          f"plain {soa[1]:.4f} ms, library {soa[2]:.4f} ms")
    return out


def phase_cr_vs_thomas(dev, B=32, T=198, n=7):
    """Cyclic reduction against the Thomas solve on the card at the long
    horizon's KKT shape; returns the max relative difference."""
    import torch

    from grasptrajopt_tpu_torch.ops.block_tridiag import block_tridiag_solve, block_tridiag_solve_cr

    gen = torch.Generator(device=dev).manual_seed(4)
    A = torch.randn((B, T, n, n), generator=gen, device=dev)
    D = A @ A.transpose(-1, -2) + 2.0 * n * torch.eye(n, device=dev)
    L = 0.3 * torch.randn((B, T - 1, n, n), generator=gen, device=dev)
    b = torch.randn((B, T, n), generator=gen, device=dev)
    x_th = block_tridiag_solve(D, L, b)
    x_cr = block_tridiag_solve_cr(D, L, b)
    rel = float((x_cr - x_th).abs().max() / x_th.abs().max())
    if not rel <= CR_RTOL:
        raise AssertionError(f"cyclic reduction differs from the Thomas solve by {rel:.3e} relative")
    t_th = statistics.median(cuda_ms(lambda: block_tridiag_solve(D, L, b), 3))
    t_cr = statistics.median(cuda_ms(lambda: block_tridiag_solve_cr(D, L, b), 3))
    print(f"[bench] KKT ({B}, {T}, {n}, {n}): cyclic reduction vs Thomas max rel diff {rel:.3e} "
          f"(tolerance {CR_RTOL:g}); median {t_cr:.3f} ms vs {t_th:.3f} ms")
    return rel


def phase_warm_start_report(bench):
    """How the bench's IK warm start does on its goals: the single-seed IK
    screen's share within 1 cm and within 5 degrees, the problems that
    bench.py's rule rescues (every goal beyond 1 cm), and the multistart
    IK's shares on the same goals."""
    B, cap = bench.tf_goal.shape[:2]
    goals = bench.tf_goal.reshape(B * cap, 4, 4)
    _, pos, rot = bench.ik.solve_ik_batch(bench.qc, goals)
    _, pos_m, rot_m = bench.ik.solve_ik_batch(bench.qc, goals, multistart=True)
    hard = int((pos.reshape(B, cap) > 0.01).all(dim=1).sum())
    print(f"[bench] IK warm start on {B * cap} goals: single seed {float((pos < 0.01).float().mean()):.4f} "
          f"within 1 cm, {float((rot < 5.0).float().mean()):.4f} within 5 degrees, median rotation error "
          f"{float(rot.median()):.2f} degrees; problems rescued {hard} of {B}; multistart "
          f"{float((pos_m < 0.01).float().mean()):.4f} within 1 cm, {float((rot_m < 5.0).float().mean()):.4f} "
          "within 5 degrees")


def phase_bench(dev):
    """The port's bench solve (grasptrajopt_tpu_torch.bench) at full width
    in its three flavours, and K4 against plain. Returns (the K4 record,
    K4 launches of one default solve)."""
    import torch

    from grasptrajopt_tpu_torch import bench as pb
    from grasptrajopt_tpu_torch.ops import interp, nn
    from grasptrajopt_tpu_torch.testing import make_synthetic_gto_robot

    robot = make_synthetic_gto_robot(device=dev, dtype=torch.float32, points_per_link=100)
    k4 = None
    default_launches = None
    for flavour, want in (("default", 3), ("two_pass", 7), ("long_horizon", 3)):
        cfg = pb.FLAVOURS[flavour]
        t0 = time.perf_counter()
        bench = pb.SolveBench(robot, cfg)
        torch.cuda.synchronize(dev)
        print(f"[bench] {flavour}: B={cfg.batch} goals {cfg.goal_capacity} T={cfg.T} iterations {cfg.iterations} "
              f"single_pass {cfg.single_pass} coarse {cfg.coarse_iterations} final_trust {cfg.final_trust} "
              f"cyclic_reduction {cfg.cyclic_reduction}; {robot.num_surface_points} body points, "
              f"{robot.grid.size}-cell grid; set-up (IK warm start) {time.perf_counter() - t0:.2f} s")
        if flavour == "default":
            k4 = phase_field_lookup_vs_plain(dev, bench)
            phase_warm_start_report(bench)
        torch.cuda.reset_peak_memory_stats(dev)
        timed = pb.time_solves(bench, reps=3, pipe_reps=5)
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        nn.min_d2_launches = nn.nearest_launches = nn.min_sqdist_launches = interp.field_lookup_launches = 0
        Q, cost, _ = bench.step()
        torch.cuda.synchronize(dev)
        counts = (nn.min_d2_launches, nn.nearest_launches, nn.min_sqdist_launches, interp.field_lookup_launches)
        if counts != (0, 0, 0, want):
            raise AssertionError(f"bench {flavour}: K1-K4 launched {counts} times a solve, expected (0, 0, 0, {want})")
        if flavour == "default":
            default_launches = counts[3]
        if tuple(Q.shape) != (cfg.batch, cfg.T, robot.num_opt_joints) or not bool(torch.isfinite(cost).all()):
            raise AssertionError(f"bench {flavour}: Q {tuple(Q.shape)}, cost {cost.tolist()}")
        check_plans(f"bench {flavour}", bench.full_q(Q), bench.qc, robot)
        err = check_plan_fields(f"bench {flavour} final fields", bench.planner, bench.table, bench.full_q(Q))
        gates = bench.gates(Q)
        print(f"[bench] {flavour}: K4 launches a solve {counts[3]}; Q finite, within limits, pinned; "
              f"final fields vs plain max |err| {err:.3e}; cost median {float(cost.median()):.4f}")
        print(f"[bench] {flavour}: latency {timed['latency_s'] * 1e3:.3f} ms (best of "
              f"{[round(t * 1e3, 3) for t in timed['latency_runs_s']]} ms), sustained "
              f"{timed['plans_per_s']:.3f} plans/s over 5 back-to-back solves; peak device memory {peak:.1f} MiB")
        print(f"[bench] {flavour}: gates {json.dumps(gates)} (reported, not gated)")
        if flavour == "long_horizon":
            phase_cr_vs_thomas(dev, cfg.batch, cfg.T - 2, robot.num_opt_joints)
        del bench, timed, Q
    return k4, default_launches


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
            rT = nn._pack_refT(shared["scene_points"])
            err = check_nearest(
                f"{name} {tier} final obstacle distances", pts, rT, shared["scene_normals"],
                nn.nearest_batched(pts, rT, shared["scene_normals"]),
                nn.nearest_batched_reference(pts, rT, shared["scene_normals"]),
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
    over a second run of it (device activity only: tracing the host's
    ~250k launches too costs minutes); busy = device time / unprofiled
    wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in ops) / 1e3
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "seconds": time.perf_counter() - t1,
        "wall_ms": 1e3 * wall_s, "device_ms": device_ms, "device_ops": sum(e.count for e in ops),
        "busy": device_ms / (1e3 * wall_s),
        "top": [[e.key[:70], e.count, round(e.self_device_time_total / 1e3, 3)] for e in top],
    }


def phase_closed_loop(dev, shelf_objects: int = 3, out_dir=None, points_per_link: int = 100, size: int = 160):
    """The closed-loop harness (grasptrajopt_tpu_torch.synthetic_eval) on
    the synthetic arm and its gripper, one object a trial at full width:
    a warm-up trial, tabletop scene 10 (nearest first, 5 objects) and shelf
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
        for st, ordering, n_obj in (("tabletop", "nearest_first", 5), ("shelf", "random", shelf_objects)):
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
    prof = profile_trial(lambda: run("tabletop", [10], 5, ["nearest_first"], prior=prior))
    print(f"[closed-loop] profile of trial {fail_name} (tabletop scene 10, its plan_object wall "
          f"{fail_wall:.3f} s in the counted run) again, with its harness scoring: "
          f"unprofiled wall {prof['wall_ms']:.1f} ms, device time {prof['device_ms']:.1f} ms, "
          f"{prof['device_ops']} device ops, busy {prof['busy']:.1%}; top {json.dumps(prof['top'])}; "
          f"the profiled run and its processing {prof['seconds']:.1f} s")

    merged = {f"{st}_10": r["10"] for st, r in results.items()}
    print(f"[closed-loop] all trials: {json.dumps(se.summary(merged))}; phase {time.perf_counter() - t0:.1f} s")


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
          f"python {sys.version.split()[0]}")

    phase_build()
    grid_pts = make_synthetic_gto_robot(device=dev, points_per_link=1).grid.grid_points(np.float32)
    max_err, k_ms, p_ms, b_ms, b_by = phase_kernel_vs_plain(grid_pts, dev)
    near = phase_nearest_vs_plain(grid_pts, dev)
    launches, path, obs, out = phase_slice(dev)
    k2_launches, k3_launches = phase_pergoal(path, obs, out, dev)
    del path, obs, out
    k4, k4_launches = phase_bench(dev)
    phase_closed_loop(dev)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")

    def record(name, source, replaces, launches, err, ms, plain_ms, bound, bound_by, library_ms):
        return {
            "name": name, "route": "cuda", "source": f"grasptrajopt_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms,
        }

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
        record("K4 field_lookup (packed-row trilinear lookup with its closed-form gradient)", "field_lookup.cu",
               "tools/probe_vmem_gather.py:52", k4_launches, k4["max_abs_err"], k4["ms"], k4["plain_ms"],
               k4["bound_ms"], k4["bound_by"], k4["library_ms"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
