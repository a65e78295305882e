#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (grasptrajopt_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

  1. device: a CUDA device is required (there is no CPU path); prints the
     card's name and power limit as nvidia-smi reports them;
  2. build: compiles the K1 kernel (csrc/min_d2.cu) with nvcc for sm_90a
     from the sources in this checkout and prints nvcc's register and
     shared-memory report;
  3. kernel vs plain: K1 against its plain-torch version on the same CUDA
     tensors, at the perception-to-plan path's widths (B = 16 clouds,
     M = 95,760 workspace grid points, N = 12,288 obstacle and 2,048 target
     points, and the pre-filter's 3,200 per-object queries) and at ragged
     sizes with an all-invalid cloud; fails above 1e-5 m^2 (squared
     distances here are below ~10 m^2, and fused multiply-adds move a
     value by a few float32 ulp, ~1e-6); median CUDA-event times of both;
  4. slice: the perception-to-plan path (16 objects of the synthetic
     tabletop scenes 10/36/48/65 at 160x160, 32 grasps each, the synthetic
     7-DoF arm with 1,000 surface points on its 95,760-cell grid, IK 50
     iterations, plan T = 50 with 3 iterations, coarse 2+1, final_trust),
     once to warm up and once counted: K1 must launch exactly 3 times (two
     field passes and the grasp pre-filter), both fields and the
     pre-filter must agree with the plain version on the clouds the card
     produced, and the plan must be finite, within the joint limits and
     pinned at its first two steps;
  5. result: the nvidia-smi line, one JSON line of kernel records, and the
     last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

FIELD_TOL = 1e-5  # m^2 for K1's d2, cost units for the shaped fields


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


def phase_build():
    from grasptrajopt_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    res = cuda_build.build("min_d2", force=True)
    print(f"[build] {' '.join(res.command)}")
    print(f"[build] {time.perf_counter() - t0:.1f} s; nvcc -Xptxas -v report:")
    for line in res.log.strip().splitlines():
        print(f"[build]   {line}")


def phase_kernel_vs_plain(grid_pts, dev):
    """K1 against the plain version; returns (max |d2 err|, kernel ms,
    plain ms) where the times are the sums over the slice's three launch
    shapes."""
    import numpy as np
    import torch

    from grasptrajopt_tpu_torch.ops import nn

    rng = np.random.default_rng(0)
    lo, hi = grid_pts.min(axis=0), grid_pts.max(axis=0)

    def clouds(B, N, valid=0.8):
        ref = torch.as_tensor(rng.uniform(lo, hi, size=(B, N, 3)), dtype=torch.float32, device=dev)
        mask = torch.as_tensor(rng.uniform(size=(B, N)) < valid, device=dev)
        return nn._pack_refT(ref, mask)

    grid = torch.as_tensor(grid_pts, dtype=torch.float32, device=dev)
    per_object = torch.as_tensor(
        rng.uniform(lo, hi, size=(16, 3_200, 3)), dtype=torch.float32, device=dev
    )
    cases = [  # (name, queries, packed clouds, part of the slice)
        ("obstacle pass B=16 M=95760 N=12288", grid, clouds(16, 12_288), True),
        ("target pass B=16 M=95760 N=2048", grid, clouds(16, 2_048), True),
        ("pre-filter B=16 M=3200/cloud N=12288", per_object, clouds(16, 12_288), True),
        ("ragged B=3 M=1000 N=1000", grid[:1_000], clouds(3, 1_000), False),
        ("ragged B=5 M=1025 N=2049", grid[:1_025], clouds(5, 2_049), False),
        ("ragged B=2 M=1 N=1", grid[:1], clouds(2, 1, valid=1.0), False),
    ]
    invalid = clouds(3, 2_100)
    invalid[1, 3] = nn.PENALTY_BIG  # cloud 1: every point invalid
    cases.append(("all-invalid cloud B=3 M=777 N=2100", grid[:777], invalid, False))

    max_err, k_ms, p_ms = 0.0, 0.0, 0.0
    for name, q, rT, timed in cases:
        got = nn.min_d2_batched(q, rT)
        if rT is invalid and not bool((got[1] >= 1e38).all()):
            raise AssertionError("K1: an all-invalid cloud must give the penalty, not a distance")
        want = nn.min_d2_batched_reference(q, rT)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"K1 {name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"K1 {name}: non-finite output")
        err = float((got.double() - want.double()).abs().max())
        if err > FIELD_TOL:
            raise AssertionError(f"K1 {name}: max |d2 err| {err:.3e} > {FIELD_TOL:g}")
        max_err = max(max_err, err)
        line = f"[kernel] {name}: max |d2 err| {err:.3e} m^2"
        if timed:
            kernel_t, plain_t = [], []
            for _ in range(5):  # in turns: plain, kernel
                plain_t += cuda_ms(lambda: nn.min_d2_batched_reference(q, rT), 1)
                kernel_t += cuda_ms(lambda: nn.min_d2_batched(q, rT), 1)
            km, pm = statistics.median(kernel_t), statistics.median(plain_t)
            k_ms, p_ms = k_ms + km, p_ms + pm
            line += f"; median kernel {km:.4f} ms, plain {pm:.4f} ms"
        print(line)
    print(f"[kernel] K1 max |d2 err| {max_err:.3e} m^2 over {len(cases)} cases (tolerance {FIELD_TOL:g})")
    return max_err, k_ms, p_ms


def phase_slice(dev):
    import torch

    from grasptrajopt_tpu_torch.e2e import (
        PerceptionToPlan, SliceConfig, collect_observations, reach_fractions,
    )
    from grasptrajopt_tpu_torch.fields.depth_point_cloud import camera_outside, cost_fields_from_d2
    from grasptrajopt_tpu_torch.ops import nn
    from grasptrajopt_tpu_torch.testing import make_synthetic_gto_robot

    cfg = SliceConfig()
    t0 = time.perf_counter()
    obs = collect_observations(cfg)
    robot = make_synthetic_gto_robot(device=dev, dtype=torch.float32, points_per_link=100)
    path = PerceptionToPlan(robot, cfg)
    print(f"[slice] set-up {time.perf_counter() - t0:.2f} s: {cfg.batch} objects, "
          f"{cfg.goal_capacity} grasps each, {robot.num_surface_points} body points, "
          f"grid {robot.grid.shape} = {robot.grid.size} cells")
    path.run(obs)  # warm-up: library handles, allocator

    nn.min_d2_launches = 0
    out = path.run(obs)
    launches = nn.min_d2_launches
    if launches != 3:
        raise AssertionError(f"K1 launched {launches} times in the slice, expected 3")

    # both fields and the pre-filter against the plain K1 on the card's clouds
    x, two = out["inputs"], out["fields"]
    grid = path.grid_pts
    d2_obs = nn.min_d2_batched_reference(grid, nn._pack_refT(two.obs_pts, two.obs_mask))
    d2_tgt = nn.min_d2_batched_reference(grid, nn._pack_refT(two.tgt_pts, two.tgt_mask))
    f_all, f_obs = cost_fields_from_d2(
        d2_obs, d2_tgt, x["depth"], x["K"], x["cam_pose"], x["target_mask"], grid,
        cfg.depth_threshold, cfg.field_epsilon,
    )
    field_err = max(float((f_all - two.f_all).abs().max()), float((f_obs - two.f_obs).abs().max()))
    if not field_err <= FIELD_TOL:
        raise AssertionError(f"fields differ from the plain K1 by {field_err:.3e}")
    gp, d_obs_img = path.filter_queries(x)
    d = torch.sqrt(nn.min_d2_batched_reference(gp, nn._pack_refT(two.obs_pts, two.obs_mask)))
    sdf = torch.where(camera_outside(d_obs_img, x["K"], x["cam_pose"], gp), d, -d)
    keep = (sdf.reshape(out["keep"].shape + (-1,)) < 0).float().mean(dim=-1) <= 0.01
    if not torch.equal(keep, out["keep"]):
        raise AssertionError("the grasp pre-filter differs from the plain K1's")
    print(f"[slice] fields vs plain K1: max |err| {field_err:.3e}; pre-filter identical")

    Q, cost = out["Q"], out["cost"]
    B, T = cfg.batch, cfg.T
    lo = torch.as_tensor(robot.lower_optimized_joint_limits, dtype=Q.dtype, device=dev)
    hi = torch.as_tensor(robot.upper_optimized_joint_limits, dtype=Q.dtype, device=dev)
    qc_opt = robot.extract_optimized_dimensions(path.qc)
    if tuple(Q.shape) != (B, T, robot.num_opt_joints):
        raise AssertionError(f"Q has shape {tuple(Q.shape)}")
    if not torch.isfinite(Q).all():
        raise AssertionError("Q is not finite")
    if not bool(((Q >= lo) & (Q <= hi)).all()):
        raise AssertionError("Q leaves the joint limits")
    if not bool((Q[:, :2] == qc_opt).all()):
        raise AssertionError("Q[:, :2] is not the start configuration")
    if not torch.isfinite(cost).all():
        raise AssertionError(f"non-finite plan cost: {cost.tolist()}")
    if not (torch.isfinite(two.f_all).all() and torch.isfinite(two.f_obs).all()):
        raise AssertionError("non-finite cost field")

    Q_full = robot.assemble_q(Q, robot.extract_parameter_dimensions(path.qc))
    reach = reach_fractions(robot, path.link_ee, Q_full, x["tf_goal"], out["goal_mask"])
    ms = {k: 1e3 * v / B for k, v in out["seconds"].items()}
    print(f"[slice] K1 launches {launches}; Q {tuple(Q.shape)} finite, within limits; "
          f"cost median {float(cost.median()):.4f}, max {float(cost.max()):.4f}")
    print(f"[slice] kept grasps {int(out['keep'].sum())}/{out['keep'].numel()}, "
          f"IK found {int(out['found'].sum())}/{out['found'].numel()}, "
          f"goal slots {int(out['goal_mask'].sum())}")
    print(f"[slice] ms per object: fields {ms['fields']:.3f}, IK {ms['ik']:.3f}, "
          f"plan {ms['plan']:.3f} (host clock around synchronized phases, batch {B})")
    print(f"[slice] reach: {json.dumps(reach)} (reported, not gated)")
    print(f"[slice] peak device memory {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    return launches


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
    grid_pts = make_synthetic_gto_robot(points_per_link=1).grid.grid_points(np.float32)
    max_err, k_ms, p_ms = phase_kernel_vs_plain(grid_pts, dev)
    launches = phase_slice(dev)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "K1 min_d2 (exact-fp32 batched min squared distance)",
        "route": "cuda",
        "source": "grasptrajopt_tpu_torch/csrc/min_d2.cu",
        "replaces": "grasptrajopt_tpu/ops/nn.py:87",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
