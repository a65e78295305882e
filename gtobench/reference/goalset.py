"""The goal-set trajectory solve in plain PyTorch, from the same start.

The problem (GraspTrajOpt's goal-set NLP as the configuration states it):
for each problem a trajectory of T joint vectors of the arm, the first two
pinned to the start pose, minimising

    sum_t |r_t(q_t)|^2 + w sum_t |q_{t+1} - q_t|^2,   lo <= q <= hi,

where r_t holds the goal rows (at the last step the hand's surface points
against the active goal's placement of them, at the standoff step against
the goal moved back along its z axis), and sqrt(obstacle_weight) times the
cost field, trilinearly interpolated, at every body surface point (the
scene field before the standoff step, the target-free field from it on).
The active goal of each problem is the goal of least point-match cost at
the current trajectory's last and standoff steps, chosen before each
iteration. w = 0.01 / dt^2.

The solver is the single-pass Levenberg-Marquardt iteration the
configuration names: one linearisation per iteration at the trial point,
whose cost is its acceptance test (accept when lower than the last
accepted cost), lambda times 0.35 on accept and 4 on reject, the damped
Gauss-Newton step of the block-tridiagonal system (Marquardt scaling plus
jitter) from the last accepted point, projected onto the joint limits. The
first `coarse_iterations` use every `coarse_stride`-th surface point of
each link; the fine phase starts again from the last accepted coarse point
with its lambda. With final_trust the last trial point is returned
unevaluated with the cost of the last accepted point.

The KKT system is solved densely (Cholesky of the whole (F n) x (F n)
matrix), and the Jacobians come from forward-mode differentiation of the
kinematics, with the field's spatial gradient from reverse mode: no part
of it is the program's arithmetic.

`solve` runs in blocks of problems, so that the float64 Jacobians fit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.func import jacfwd, vmap

from gtobench.reference.synth7 import ARM_JOINTS, Grid, Synth7, trilinear


@dataclass(frozen=True)
class Problem:
    T: int = 50
    iterations: int = 3
    coarse_iterations: int = 2
    coarse_stride: int = 2
    final_trust: bool = True
    standoff_distance: float = -0.1
    standoff_offset: int = -10
    obstacle_weight: float = 10.0
    goal_weight: float = 1.0
    Tmax: float = 10.0
    lambda_init: float = 1e-3
    lambda_decrease: float = 0.35
    lambda_increase: float = 4.0
    lambda_min: float = 1e-9
    lambda_max: float = 1e8
    jitter: float = 1e-9
    n_fixed: int = 2

    @classmethod
    def from_config(cls, cfg: dict) -> "Problem":
        keys = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in cfg.items() if k in keys})


class GoalSetSolve:
    """The solve of `Problem` for synth7 on one device and dtype.

    fields: (S,) one field for every problem and phase, or (B, 2, S) per
    problem (scene, target-free)."""

    def __init__(self, arm: Synth7, grid: Grid, problem: Problem):
        self.arm, self.grid, self.p = arm, grid, problem
        self.dtype, self.device = arm.dtype, arm.device
        n_opt = len(ARM_JOINTS)
        self.n = n_opt
        self.lo = torch.as_tensor(arm.lower, dtype=self.dtype, device=self.device)
        self.hi = torch.as_tensor(arm.upper, dtype=self.dtype, device=self.device)
        dt = problem.Tmax / (problem.T - 1)
        self.w = 0.01 / dt**2
        self.t_standoff = problem.T + problem.standoff_offset
        # the standoff as the configuration states it, a float32 distance
        self.standoff = torch.eye(4, dtype=self.dtype, device=self.device)
        self.standoff[2, 3] = float(torch.tensor(problem.standoff_distance, dtype=torch.float32))

    # -- residuals ------------------------------------------------------------

    def _full(self, q_opt, q_fingers):
        return torch.cat([q_opt, q_fingers.expand(q_opt.shape[:-1] + q_fingers.shape[-1:])], -1)

    def _hand_pts(self, T_hand):
        """The hand's points placed by (..., 4, 4) poses -> (..., Pg, 3)."""
        g = self.arm.hand_points.to(T_hand.dtype)
        return g @ T_hand[..., :3, :3].transpose(-1, -2) + T_hand[..., None, :3, 3]

    def goal_costs(self, Q, q_fingers, tf_goal, goal_mask):
        """(B, G) point-match cost of each goal at the trajectories Q
        (B, T, n): the last step against the goal, the standoff step
        against the standoff goal; masked goals at inf."""
        T = self.p.T
        hand_f = self.arm.link_transforms(self._full(Q[:, T - 1], q_fingers))["hand"]
        hand_s = self.arm.link_transforms(self._full(Q[:, self.t_standoff], q_fingers))["hand"]
        pf = self._hand_pts(hand_f)[:, None]  # (B, 1, Pg, 3)
        ps = self._hand_pts(hand_s)[:, None]
        gf = self._hand_pts(tf_goal)  # (B, G, Pg, 3)
        gs = self._hand_pts(tf_goal @ self.standoff)
        c = ((pf - gf) ** 2).sum((-2, -1)) + ((ps - gs) ** 2).sum((-2, -1))
        return torch.where(goal_mask, c, torch.full_like(c, math.inf))

    def _goal_poses(self, tf_goal, goal):
        rows = torch.arange(tf_goal.shape[0], device=tf_goal.device)
        g = tf_goal[rows, goal]
        return g, g @ self.standoff

    def _obstacle_pts_fn(self, stride):
        pts_local = self.arm.link_points(stride)
        links = self.arm.links

        def pts(q_full):
            T = self.arm.link_transforms(q_full)
            out = [p.to(q_full.dtype) @ T[n][:3, :3].T + T[n][:3, 3] for n, p in zip(links, pts_local)]
            out = torch.cat(out, 0)
            return out, out

        return pts

    def linearise(self, X, qc_opt, q_fingers, goal, tf_goal, fields, stride, base, with_jac=True):
        """Cost (B,), and with_jac the Gauss-Newton blocks H (B, F, n, n)
        and g (B, F, n) (g = grad / 2) over the free steps, at X
        (B, F, n). The body points are in the robot's frame moved by its
        base position base (B, 3) into the field's frame."""
        p = self.p
        B, F, n = X.shape
        T, nf = p.T, p.n_fixed
        Q = torch.cat([qc_opt[:, None].expand(B, nf, n), X], 1)  # (B, T, n)
        qfull = self._full(Q, q_fingers[:, None])  # (B, T, 9)
        # obstacle rows at every step of every problem
        flat = qfull.reshape(B * T, -1)
        if with_jac:
            J_pts, pts = vmap(jacfwd(self._obstacle_pts_fn(stride), has_aux=True))(flat)  # (BT, P, 3, 9)
        else:
            pts = vmap(lambda q: self._obstacle_pts_fn(stride)(q)[0])(flat)
        pts = pts.reshape(B, T, -1, 3) + base[:, None, None, :]
        slab = (torch.arange(T, device=X.device) >= self.t_standoff).long()  # 0 scene, 1 target-free
        if fields.dim() == 1:
            offset = 0
        else:  # (B, 2, S): each (problem, step) reads its problem's scene or target-free field
            S = fields.shape[-1]
            offset = (torch.arange(B, device=X.device)[:, None] * 2 + slab[None, :]) * S
            offset = offset[..., None]  # (B, T, 1)
        pts_req = pts.detach().requires_grad_(with_jac)
        with torch.enable_grad():
            val = trilinear(fields, self.grid, pts_req, offset)
        sow = math.sqrt(p.obstacle_weight)
        r_obs = sow * val.detach()
        c = (r_obs**2).sum((1, 2))
        # goal rows at the last and standoff steps
        g_final, g_stand = self._goal_poses(tf_goal, goal)
        sgw = math.sqrt(p.goal_weight)
        hand_pts_goal = {T - 1: self._hand_pts(g_final), self.t_standoff: self._hand_pts(g_stand)}

        def hand_fn(q_full):
            out = self._hand_pts(self.arm.link_transforms(q_full)["hand"])
            return out, out

        goal_terms = {}
        for t, target in hand_pts_goal.items():
            if with_jac:
                Jh, ph = vmap(jacfwd(hand_fn, has_aux=True))(qfull[:, t])  # (B, Pg, 3, 9)
            else:
                ph = vmap(lambda q: hand_fn(q)[0])(qfull[:, t])
                Jh = None
            r = sgw * (ph - target)
            c = c + (r**2).sum((1, 2))
            goal_terms[t] = (r, Jh)
        dq = Q[:, 1:] - Q[:, :-1]
        c = c + self.w * (dq**2).sum((1, 2))
        if not with_jac:
            return c
        (grad_pts,) = torch.autograd.grad(val.sum(), pts_req)
        grad_pts = grad_pts.reshape(B, T, -1, 3)
        J_pts = J_pts.reshape(B, T, -1, 3, J_pts.shape[-1])[..., :n]
        J_obs = sow * torch.einsum("btpc,btpcj->btpj", grad_pts, J_pts)  # (B, T, P, n)
        H = torch.einsum("btpi,btpj->btij", J_obs[:, nf:], J_obs[:, nf:])
        g = torch.einsum("btpi,btp->bti", J_obs[:, nf:], r_obs[:, nf:])
        for t, (r, Jh) in goal_terms.items():
            Jg = sgw * Jh[..., :n].reshape(B, -1, n)
            H[:, t - nf] += Jg.transpose(1, 2) @ Jg
            g[:, t - nf] += (Jg.transpose(1, 2) @ r.reshape(B, -1, 1))[..., 0]
        # smoothness: the gradient / 2 with respect to the free steps
        inner = 2.0 * Q[:, nf:-1] - Q[:, nf - 1:-2] - Q[:, nf + 1:]
        last = Q[:, -1] - Q[:, -2]
        g = g + self.w * torch.cat([inner, last[:, None]], 1)
        return c, H, g

    def step(self, H, g, lam):
        """The damped step dX (B, F, n) from (H, g) at lambda (B,): the
        block-tridiagonal system (diagonal blocks H + smoothness +
        Marquardt damping, off-diagonal -w I) solved densely."""
        B, F, n, _ = H.shape
        eye = torch.eye(n, dtype=H.dtype, device=H.device)
        vel = torch.full((F,), 2.0 * self.w, dtype=H.dtype, device=H.device)
        vel[-1] = self.w
        diag = torch.diagonal(H, dim1=-2, dim2=-1) + vel[:, None]
        scale = torch.clamp(diag, min=self.p.jitter)
        D = H + vel[:, None, None] * eye + lam[:, None, None, None] * torch.diag_embed(scale) + self.p.jitter * eye
        A = torch.zeros((B, F * n, F * n), dtype=H.dtype, device=H.device)
        for f in range(F):
            A[:, f * n:(f + 1) * n, f * n:(f + 1) * n] = D[:, f]
            if f + 1 < F:
                A[:, f * n:(f + 1) * n, (f + 1) * n:(f + 2) * n] = -self.w * eye
                A[:, (f + 1) * n:(f + 2) * n, f * n:(f + 1) * n] = -self.w * eye
        L = torch.linalg.cholesky(A)
        return -torch.cholesky_solve(g.reshape(B, F * n, 1), L).reshape(B, F, n)

    def solve(self, qc_opt, X0, q_fingers, tf_goal, goal_mask, fields, base, block: int = 128):
        """(Q (B, T, n), cost (B,)) from the start X0 (B, T - 2, n), in
        blocks of `block` problems. qc_opt (B, n); q_fingers (B, 2);
        tf_goal (B, G, 4, 4) in the robot's frame; goal_mask (B, G); fields
        as the class says; base (B, 3) the robot's base in the field's
        frame."""
        outs = []
        for s in range(0, X0.shape[0], block):
            sl = slice(s, s + block)
            f = fields if fields.dim() == 1 else fields[sl]
            outs.append(self._solve(qc_opt[sl], X0[sl], q_fingers[sl], tf_goal[sl], goal_mask[sl], f, base[sl]))
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    def _solve(self, qc_opt, X0, q_fingers, tf_goal, goal_mask, fields, base):
        p = self.p
        B = X0.shape[0]
        nf = p.n_fixed

        def active(X):
            Q = torch.cat([qc_opt[:, None].expand(B, nf, self.n), X], 1)
            return torch.argmin(self.goal_costs(Q, q_fingers, tf_goal, goal_mask), dim=1)

        def clip(X):
            return torch.minimum(torch.maximum(X, self.lo), self.hi)

        X_try = clip(X0)
        X_acc = X_try
        H_acc = g_acc = None
        c_acc = torch.full((B,), math.inf, dtype=self.dtype, device=self.device)
        lam = torch.full((B,), p.lambda_init, dtype=self.dtype, device=self.device)
        strides = [p.coarse_stride] * p.coarse_iterations + [1] * (p.iterations - p.coarse_iterations)
        for it, stride in enumerate(strides):
            if it == p.coarse_iterations and it > 0:  # the fine phase starts from the last accepted point
                X_try = X_acc
                c_acc = torch.full_like(c_acc, math.inf)
                H_acc = g_acc = None
            c_try, H_try, g_try = self.linearise(X_try, qc_opt, q_fingers, active(X_try), tf_goal, fields, stride, base)
            accept = (c_try < c_acc) & torch.isfinite(c_try)
            a3, a4 = accept[:, None, None], accept[:, None, None, None]
            X_acc = torch.where(a3, X_try, X_acc)
            H_acc = H_try if H_acc is None else torch.where(a4, H_try, H_acc)
            g_acc = g_try if g_acc is None else torch.where(a3, g_try, g_acc)
            c_acc = torch.where(accept, c_try, c_acc)
            lam = torch.clamp(torch.where(accept, lam * p.lambda_decrease, lam * p.lambda_increase),
                              p.lambda_min, p.lambda_max)
            X_try = clip(X_acc + self.step(H_acc, g_acc, lam))
        if p.final_trust:
            X_out, c_out = X_try, c_acc
        else:
            c_try = self.linearise(X_try, qc_opt, q_fingers, active(X_try), tf_goal, fields, 1, base, with_jac=False)
            take = (c_try < c_acc) & torch.isfinite(c_try)
            X_out = torch.where(take[:, None, None], X_try, X_acc)
            c_out = torch.where(take, c_try, c_acc)
        Q = torch.cat([qc_opt[:, None].expand(B, nf, self.n), X_out], 1)
        return Q, c_out
