"""Point-matching inverse kinematics of synth7 in plain PyTorch.

For each goal pose, the arm's joints minimise the summed squared distance
between the hand's surface points at the joints and the same points placed
at the goal, inside the joint limits, by a projected Levenberg-Marquardt
iteration: the Gauss-Newton Hessian with Marquardt's diagonal damping, a
ladder of step scales all evaluated at once (the least cost taken if it
lowers the cost), lambda times 0.35 when the gain ratio passes 1/4, 0.7 on
a lesser gain, 4 on a rejected step. The Jacobian comes from forward-mode
differentiation of the reference's kinematics. A multistart solve starts
every goal from the start pose and from restarts drawn uniformly inside
the limits (clipped to +-3.2) by a torch.Generator on the device seeded as
the configuration states, and keeps the start of least final cost.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch.func import jacfwd, vmap

from gtobench.reference.synth7 import Synth7


@dataclass(frozen=True)
class IKProblem:
    iterations: int = 50
    alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1, 0.03)
    lambda_init: float = 1e-3
    jitter: float = 1e-9


class PointIK:
    def __init__(self, arm: Synth7, problem: IKProblem = IKProblem()):
        self.arm, self.p = arm, problem
        self.lo = torch.as_tensor(arm.lower, dtype=arm.dtype, device=arm.device)
        self.hi = torch.as_tensor(arm.upper, dtype=arm.dtype, device=arm.device)

    def _residual(self, q_opt, q_fingers, goal_pts):
        q = torch.cat([q_opt, q_fingers], -1)
        T = self.arm.link_transforms(q)["hand"]
        g = self.arm.hand_points.to(q.dtype)
        pts = g @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
        return (pts - goal_pts).reshape(q_opt.shape[:-1] + (-1,))

    def solve(self, x0, q_fingers, goals):
        """Final joints (N, n) and costs (N,) from starts x0 (N, n); q_fingers
        (N, 2); goals (N, 4, 4) in the robot's frame."""
        p = self.p
        g = self.arm.hand_points.to(x0.dtype)
        goal_pts = g @ goals[..., :3, :3].transpose(-1, -2) + goals[..., None, :3, 3]
        x = torch.minimum(torch.maximum(x0, self.lo), self.hi)
        N, n = x.shape
        eye = torch.eye(n, dtype=x.dtype, device=x.device)
        alphas = torch.as_tensor(p.alphas, dtype=x.dtype, device=x.device)

        def lin(xx, qf, gp):
            def f(v):
                r = self._residual(v, qf, gp)
                return r, r

            return jacfwd(f, has_aux=True)(xx)

        lam = torch.full((N,), p.lambda_init, dtype=x.dtype, device=x.device)
        c = (self._residual(x, q_fingers, goal_pts) ** 2).sum(-1)
        for _ in range(p.iterations):
            J, r = vmap(lin)(x, q_fingers, goal_pts)
            c_now = (r * r).sum(-1)
            grad = torch.einsum("bri,br->bi", J, r)
            H = torch.einsum("bri,brj->bij", J, J)
            scale = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=p.jitter)
            A = H + lam[:, None, None] * torch.diag_embed(scale) + p.jitter * eye
            dx = -torch.linalg.solve(A, grad)
            cands = torch.minimum(torch.maximum(x[:, None] + alphas[None, :, None] * dx[:, None], self.lo), self.hi)
            A_ = alphas.shape[0]
            cc = (self._residual(cands, q_fingers[:, None].expand(N, A_, -1), goal_pts[:, None]) ** 2).sum(-1)
            best = torch.argmin(cc, 1)
            rows = torch.arange(N, device=x.device)
            x_t, c_t = cands[rows, best], cc[rows, best]
            step = x_t - x
            pred = -2.0 * (grad * step).sum(-1) - (step * (A @ step[..., None])[..., 0]).sum(-1)
            actual = c_now - c_t
            accept = (actual > 0) & torch.isfinite(c_t)
            good = accept & (actual / torch.clamp(pred, min=1e-12) > 0.25)
            x = torch.where(accept[:, None], x_t, x)
            c = torch.where(accept, c_t, c_now)
            lam = torch.clamp(torch.where(good, lam * 0.35, torch.where(accept, lam * 0.7, lam * 4.0)), 1e-9, 1e8)
        return x, c

    def restarts(self, n_goals: int, seeds: int, seed: int, dtype, device):
        """(n_goals, seeds - 1, n) restarts: uniform inside the limits
        clipped to +-3.2, from a torch.Generator on `device` seeded with
        `seed`, drawn in `dtype`."""
        lo, hi = torch.clamp(self.lo, -3.2, 3.2), torch.clamp(self.hi, -3.2, 3.2)
        gen = torch.Generator(device=device).manual_seed(seed)
        u = torch.rand((n_goals, seeds - 1, lo.shape[0]), generator=gen, dtype=dtype, device=device)
        return (lo.to(dtype) + u * (hi - lo).to(dtype)).to(self.lo.dtype)

    def errors(self, q_opt, q_fingers, goals):
        """Position (m) and rotation (degrees) error of the hand at q_opt
        (N, n) against goals (N, 4, 4) (or (N, G, 4, 4), broadcast)."""
        T = self.arm.link_transforms(torch.cat([q_opt, q_fingers], -1))["hand"]
        if goals.dim() == 4:
            T = T[:, None]
        d = torch.linalg.vector_norm(goals[..., :3, 3] - T[..., :3, 3], dim=-1)
        R = T[..., :3, :3].transpose(-1, -2) @ goals[..., :3, :3]
        cos = ((R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0).clamp(-1.0, 1.0)
        return d, torch.rad2deg(torch.arccos(cos))
