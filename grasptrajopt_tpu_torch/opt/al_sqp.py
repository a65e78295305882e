"""General constrained NLP solver: augmented Lagrangian with damped-Newton
inner iterations, box projection and fixed budgets.

Port of grasptrajopt_tpu/opt/al_sqp.py, for arbitrary smooth

  min f(x, p)   s.t.  h(x, p) = 0,  g(x, p) >= 0,  lo <= x <= hi

with derivatives by `torch.func`. Method: PHR augmented Lagrangian

  L(x) = f + lam.h + rho/2 ||h||^2 + 1/(2 rho) sum(max(0, mu - rho g)^2 - mu^2)

Outer updates: lam += rho h; mu = max(0, mu - rho g); rho grows when the
constraint violation stalls. Inner: Marquardt-damped Newton steps on the
exact Hessian of L (forward over reverse mode), the trial steps at 5
scales projected onto the box, the best accepted when it lowers L.

Everything stays on the device: the solve is `torch.linalg.solve_ex`
(which neither raises on a singular matrix nor reads its status back to
the host) with the gradient step where the solve is not finite, and the
accept / damping / rho updates are `torch.where`s; the budgets are Python
loops, so a solve never waits for the device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.func import grad, jacfwd, vmap

from grasptrajopt_tpu_torch.ops.constants import device_vector


class ALSQPConfig(NamedTuple):
    outer_iterations: int = 10
    inner_iterations: int = 15
    rho_init: float = 10.0
    rho_growth: float = 4.0
    rho_max: float = 1e6
    lambda_init: float = 1e-3
    lambda_decrease: float = 0.5
    lambda_increase: float = 4.0
    alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1, 0.03)
    jitter: float = 1e-8


def make_al_sqp_solver(
    f: Callable,
    h: Optional[Callable] = None,
    g: Optional[Callable] = None,
    config: ALSQPConfig = ALSQPConfig(),
):
    """Build `solve(x0, lo, hi, params) -> (x, info)`.

    f(x, p) -> scalar; h(x, p) -> (nh,) equalities; g(x, p) -> (ng,)
    inequalities (>= 0). Either constraint function may be None. x0, lo
    and hi are (n,) tensors on one device (lo / hi may be +-inf).
    """

    def h_fn(x, p):
        return h(x, p) if h is not None else x.new_zeros(0)

    def g_fn(x, p):
        return g(x, p) if g is not None else x.new_zeros(0)

    def al(x, p, lam, mu, rho):
        hv = h_fn(x, p)
        gv = g_fn(x, p)
        val = f(x, p) + torch.dot(lam, hv) + 0.5 * rho * torch.dot(hv, hv)
        shifted = torch.clamp(mu - rho * gv, min=0.0)
        return val + (torch.dot(shifted, shifted) - torch.dot(mu, mu)) / (2.0 * rho)

    grad_al = grad(al)

    def grad_twice(x, p, lam, mu, rho):
        gv = grad_al(x, p, lam, mu, rho)
        return gv, gv

    # the exact Hessian (jacfwd of the reverse-mode gradient, as
    # torch.func.hessian computes it) with the gradient from the same pass
    hess_and_grad = jacfwd(grad_twice, has_aux=True)
    al_cands = vmap(al, in_dims=(0, None, None, None, None))

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    def solve(x0, lo, hi, params):
        dtype, dev = x0.dtype, x0.device
        n = x0.shape[0]
        eye = torch.eye(n, dtype=dtype, device=dev)
        alphas = device_vector(config.alphas, dtype, dev)
        lo = torch.as_tensor(lo, dtype=dtype, device=dev)
        hi = torch.as_tensor(hi, dtype=dtype, device=dev)
        nh = h_fn(x0, params).shape[0]
        ng = g_fn(x0, params).shape[0]

        def inner(x, lam, mu, rho):
            damp = torch.tensor(config.lambda_init, dtype=dtype, device=dev)
            c = al(x, params, lam, mu, rho)
            for _ in range(config.inner_iterations):
                H, gvec = hess_and_grad(x, params, lam, mu, rho)
                scale = torch.clamp(torch.abs(torch.diagonal(H)), min=config.jitter)
                A = H + damp * torch.diag(scale) + config.jitter * eye
                # an indefinite or singular A: fall back to the gradient step
                dx = -torch.linalg.solve_ex(A, gvec)[0]
                dx = torch.where(torch.all(torch.isfinite(dx)), dx, -gvec)
                cands = clip(x[None] + alphas[:, None] * dx[None], lo, hi)
                costs = al_cands(cands, params, lam, mu, rho)
                best = torch.argmin(costs)
                accept = costs[best] < c
                x = torch.where(accept, cands[best], x)
                c = torch.where(accept, costs[best], c)
                damp = torch.clamp(
                    torch.where(accept, damp * config.lambda_decrease, damp * config.lambda_increase),
                    1e-10,
                    1e10,
                )
            return x

        x = clip(torch.as_tensor(x0, dtype=dtype, device=dev), lo, hi)
        lam = torch.zeros(nh, dtype=dtype, device=dev)
        mu = torch.zeros(ng, dtype=dtype, device=dev)
        rho = torch.tensor(config.rho_init, dtype=dtype, device=dev)
        viol = torch.tensor(float("inf"), dtype=dtype, device=dev)
        for _ in range(config.outer_iterations):
            x = inner(x, lam, mu, rho)
            hv = h_fn(x, params)
            gv = g_fn(x, params)
            lam = lam + rho * hv
            mu = torch.clamp(mu - rho * gv, min=0.0)
            viol_prev = viol
            viol = torch.sqrt(torch.sum(hv * hv) + torch.sum(torch.clamp(gv, max=0.0) ** 2))
            rho = torch.where(
                viol > 0.25 * viol_prev, torch.clamp(rho * config.rho_growth, max=config.rho_max), rho
            )
        info = {
            "f": f(x, params),
            "constraint_violation": viol,
            "lam": lam,
            "mu": mu,
            "rho": rho,
        }
        return x, info

    return solve
