"""Time-optimal path parameterization (TOPP) under joint velocity and
acceleration limits — first-party replacement for the reference's optional
toppra dependency (gto/utils.py:283-324 convert_plan_to_trajectory_toppra).

Method: numerical-integration TOPP on the squared path velocity. For a
path q(s), s in [0, 1], with derivatives q' and q'':
    qd  = q' sdot,   qdd = q'' sdot^2 + q' sddot
Velocity limits bound sdot^2 <= min_i (vmax_i / |q'_i|)^2; acceleration
limits bound sddot per joint given sdot. A forward pass integrates the
maximum reachable sdot^2 under accel limits, a backward pass enforces
decelerability, both clipped to the velocity bound — the classic
two-pass Bobrow/TOPP recursion, implemented as numpy host code (retiming
is an offline post-process, not a hot path).

convert_plan_to_trajectory returns (qs, qds, qdds, ts) sampled on a
uniform time grid, matching the reference's output signature.

Copy of grasptrajopt_tpu/planning/retiming.py (host numpy / scipy); a
plan given as a tensor, on the card or the CPU, is brought to the host
first.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy.interpolate import CubicSpline


def _host(plan) -> np.ndarray:
    """A (ndof, T) plan as a float64 host array (tensors on any device)."""
    if isinstance(plan, torch.Tensor):
        plan = plan.detach().cpu()
    return np.asarray(plan, dtype=float)


def toppra_retime(
    plan: np.ndarray,
    vlims: np.ndarray,
    alims: np.ndarray,
    grid_points: int = 200,
) -> Tuple[CubicSpline, np.ndarray, np.ndarray]:
    """Retime a (ndof, T) plan. Returns (path spline over s, s grid,
    sdot^2 profile on the grid)."""
    plan = _host(plan)
    ndof, T = plan.shape
    ss_way = np.linspace(0.0, 1.0, T)
    path = CubicSpline(ss_way, plan.T, bc_type="natural")  # rest-to-rest comes
    # from the x(0)=x(1)=0 TOPP boundary conditions, not the path spline;
    # a clamped spline would create a q'~0 boundary layer that degrades the
    # discretized recursion
    dpath = path.derivative(1)
    ddpath = path.derivative(2)

    s = np.linspace(0.0, 1.0, grid_points)
    ds = s[1] - s[0]
    qp = dpath(s)  # (N, ndof)
    qpp = ddpath(s)

    eps = 1e-6
    vlims = np.asarray(vlims, dtype=float).reshape(-1)
    alims = np.asarray(alims, dtype=float).reshape(-1)

    # velocity bound on x = sdot^2
    with np.errstate(divide="ignore"):
        x_vel = np.min((vlims / np.maximum(np.abs(qp), eps)) ** 2, axis=1)

    # where |q'_j| ~ 0 (e.g. clamped endpoints) the acceleration constraint
    # |q''_j x + q'_j u| <= a_j degenerates to the STATE bound
    # x <= a_j / |q''_j| — fold it into the per-point cap
    small = np.abs(qp) < 1e-3
    with np.errstate(divide="ignore"):
        state_bound = np.where(small, alims[None, :] / np.maximum(np.abs(qpp), eps), np.inf)
    x_cap = np.minimum(x_vel, state_bound.min(axis=1))

    def accel_range(i, x):
        """Feasible [sddot_min, sddot_max] at grid point i given x=sdot^2."""
        lo, hi = -np.inf, np.inf
        for j in range(ndof):
            a = qp[i, j]
            b = qpp[i, j] * x
            if abs(a) < 1e-3:
                continue  # handled by the state bound above
            u1 = (alims[j] - b) / a
            u2 = (-alims[j] - b) / a
            lo = max(lo, min(u1, u2))
            hi = min(hi, max(u1, u2))
        return lo, hi

    # forward pass: max reachable x under accel limits (an unbounded
    # accel range — all |q'| ~ 0, e.g. at rest endpoints of a clamped
    # path — imposes NO restriction: jump straight to the velocity bound)
    x_fwd = np.zeros(grid_points)
    x_fwd[0] = 0.0
    for i in range(grid_points - 1):
        _, u_max = accel_range(i, x_fwd[i])
        if np.isfinite(u_max):
            x_next = x_fwd[i] + 2.0 * ds * max(u_max, 0.0)
        else:
            x_next = x_cap[i + 1]
        x_fwd[i + 1] = min(max(x_next, 0.0), x_cap[i + 1])

    # backward pass: decelerability to stop at s=1
    x = x_fwd.copy()
    x[-1] = 0.0
    for i in range(grid_points - 2, -1, -1):
        u_min, _ = accel_range(i + 1, x[i + 1])
        if np.isfinite(u_min):
            x_prev = x[i + 1] - 2.0 * ds * min(u_min, 0.0)
        else:
            x_prev = x_cap[i]
        x[i] = min(x[i], max(x_prev, 0.0), x_cap[i])

    return path, s, x


def convert_plan_to_trajectory(
    robot,
    plan: np.ndarray,
    accel_limit: float = 0.5,
    num_samples: int = 100,
    grid_points: int = 200,
):
    """Reference-compatible entry: (qs, qds, qdds, ts) sampled uniformly in
    time. `robot` supplies velocity limits for the optimized joints; the
    acceleration limit defaults to 0.5 rad/s^2 like the reference."""
    plan = _host(plan)
    ndof = plan.shape[0]
    vlims = np.asarray(robot.velocity_optimized_joint_limits, dtype=float).reshape(-1)
    if vlims.shape[0] != ndof:
        vlims = np.asarray(robot.velocity_actuated_joint_limits, dtype=float).reshape(-1)
    vlims = np.clip(vlims, 1e-3, 1e3)
    alims = np.full(ndof, accel_limit)

    path, s, x = toppra_retime(plan, vlims, alims, grid_points)

    # time per interval: dt = 2 ds / (sdot_i + sdot_{i+1}) — exact under
    # constant acceleration within the interval, and finite at rest
    # endpoints where sdot = 0 (a trapezoid on 1/sdot would diverge there)
    sdot = np.sqrt(np.maximum(x, 0.0))
    ds = s[1] - s[0]
    pair = np.maximum(sdot[1:] + sdot[:-1], 1e-9)
    t_grid = np.concatenate([[0.0], np.cumsum(2.0 * ds / pair)])
    duration = t_grid[-1]

    ts = np.linspace(0.0, duration, num_samples)
    s_of_t = np.interp(ts, t_grid, s)
    sdot_of_t = np.interp(ts, t_grid, sdot)
    # sddot by finite differences of sdot over time
    sddot_of_t = np.gradient(sdot_of_t, ts, edge_order=1)

    qp = path.derivative(1)(s_of_t)
    qpp = path.derivative(2)(s_of_t)
    qs = path(s_of_t)
    qds = qp * sdot_of_t[:, None]
    qdds = qpp * (sdot_of_t**2)[:, None] + qp * sddot_of_t[:, None]
    return qs, qds, qdds, ts
