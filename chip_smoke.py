#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (grasptrajopt_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

  1. device: a CUDA device is required (there is no CPU path); prints the
     card's name and power limit as nvidia-smi reports them;
  2. build: compiles the kernels (csrc/min_d2.cu: K1; csrc/nearest.cu: K2
     and K3) with nvcc for sm_90a from the sources in this checkout, one
     nvcc per source, all started together, and prints nvcc's register
     and shared-memory report;
  3. kernel vs plain: K1 against its plain-torch version on the same CUDA
     tensors, at the perception-to-plan path's widths (B = 16 clouds,
     M = 95,760 workspace grid points, N = 12,288 obstacle and 2,048 target
     points, and the pre-filter's 3,200 per-object queries) and at ragged
     sizes with an all-invalid cloud; fails above 1e-5 m^2 (squared
     distances here are below ~10 m^2, and fused multiply-adds move a
     value by a few float32 ulp, ~1e-6); median CUDA-event times of both;
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
     field passes and the grasp pre-filter), both fields and the
     pre-filter must agree with the plain version on the clouds the card
     produced, and the plan must be finite, within the joint limits and
     pinned at its first two steps;
  6. per-goal tiers: for every object its kept and found grasps (all 32
     where none survives), one single-goal problem each (512 in all): the
     exact tier (points mode, 12 iterations, obstacle weight 40, against
     each object's 4,096 / 1,024-point scene sets) and the rescue tier
     (field mode at the plan's flavor), once to warm up and once counted:
     K2 must launch exactly 2 x (12 + 1) = 26 times (two point sets per
     pass) and K3 once (the tiers' clearance), the plans of both tiers
     must be finite, within the joint limits and pinned at their first two
     steps, and the exact tier's final obstacle distances must agree with
     the plain K2's. Both tiers run over every object, because the replay
     scorer that picks the objects to escalate is not ported;
  7. result: the nvidia-smi line, one JSON line of kernel records, and the
     last line {"ok": true, "device": {...}}.
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
KERNEL_SOURCES = ("min_d2", "nearest")


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
    kernel ms, plain ms), "K3": (...)}, the times summed over each mode's
    exact-tier launch shapes. m_tier: one object's queries in the exact
    tier (goal slots x T x body points)."""
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

    out = {"K2": [0.0, 0.0, 0.0], "K3": [0.0, 0.0, 0.0]}
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
            rec[1], rec[2] = rec[1] + km, rec[2] + pm
            pairs = q.shape[-2] * rT.shape[0] * rT.shape[2]
            line += (f"; median kernel {km:.4f} ms, plain {pm:.4f} ms; "
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
    from grasptrajopt_tpu_torch.ops import nn
    from grasptrajopt_tpu_torch.testing import make_synthetic_gto_robot

    cfg = cfg or SliceConfig()
    t0 = time.perf_counter()
    obs = collect_observations(cfg)
    robot = make_synthetic_gto_robot(device=dev, dtype=torch.float32, points_per_link=100)
    path = PerceptionToPlan(robot, cfg)
    torch.cuda.reset_peak_memory_stats(dev)
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
    if tuple(Q.shape) != (B, T, robot.num_opt_joints):
        raise AssertionError(f"Q has shape {tuple(Q.shape)}")
    Q_full = robot.assemble_q(Q, robot.extract_parameter_dimensions(path.qc))
    check_plans("the plan", Q_full, path.qc, robot)
    if not torch.isfinite(cost).all():
        raise AssertionError(f"non-finite plan cost: {cost.tolist()}")
    if not (torch.isfinite(two.f_all).all() and torch.isfinite(two.f_obs).all()):
        raise AssertionError("non-finite cost field")

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
    print(f"[pergoal] {C} objects x {G} goal slots = {C * G} problems, real goals {int(n.sum())}; "
          f"K1 {k1}, K2 {k2}, K3 {k3} launches; exact tier final obstacle d2 vs plain K2: "
          f"max |err| {err:.3e} m^2")
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
    return k2, k3


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
    near = phase_nearest_vs_plain(grid_pts, dev)
    launches, path, obs, out = phase_slice(dev)
    k2_launches, k3_launches = phase_pergoal(path, obs, out, dev)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")

    print(smi)
    print(json.dumps({"kernels": [
        {
            "name": "K1 min_d2 (exact-fp32 batched min squared distance)",
            "route": "cuda",
            "source": "grasptrajopt_tpu_torch/csrc/min_d2.cu",
            "replaces": "grasptrajopt_tpu/ops/nn.py:87",
            "launches": launches,
            "max_abs_err": max_err,
            "ms": k_ms,
            "plain_ms": p_ms,
        },
        {
            "name": "K2 nearest (nearest point, index and normal)",
            "route": "cuda",
            "source": "grasptrajopt_tpu_torch/csrc/nearest.cu",
            "replaces": "grasptrajopt_tpu/ops/nn.py:296",
            "launches": k2_launches,
            "max_abs_err": near["K2"][0],
            "ms": near["K2"][1],
            "plain_ms": near["K2"][2],
        },
        {
            "name": "K3 min_sqdist (nearest.cu in its index-only mode: d2 and argmin under a mask)",
            "route": "cuda",
            "source": "grasptrajopt_tpu_torch/csrc/nearest.cu",
            "replaces": "grasptrajopt_tpu/ops/nn.py:420",
            "launches": k3_launches,
            "max_abs_err": near["K3"][0],
            "ms": near["K3"][1],
            "plain_ms": near["K3"][2],
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
