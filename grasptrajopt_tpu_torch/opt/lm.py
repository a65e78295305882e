"""Dense projected Levenberg-Marquardt with box constraints, batch-first.

Port of grasptrajopt_tpu/opt/lm.py `make_box_lm_solver` and its one-problem
wrapper `solve_box_lm`:

    min_x ||r(x, p)||^2 + v(x, p)   s.t.  lo <= x <= hi

Gauss-Newton Hessian from r, Marquardt diagonal damping adapted by a gain
ratio, trial steps at several scales projected onto the box; the best
candidate is accepted when it lowers the cost. The residual is written for
ONE problem and mapped over the batch with `torch.func.vmap`; its Jacobian
comes from `jacfwd(has_aux=True)`.

The optional value term v (the IK screen's obstacle cost, linear in field
values, so it adds gradient but no Gauss-Newton curvature) is batch-level
instead: a pair of functions called outside the torch.func transforms, so
that a kernel (K4's field lookup) can evaluate it on the card. With the
convention C = sum r^2 + v and g = grad C / 2: g = J^T r + dv / 2.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.func import grad_and_value, jacfwd, vmap
from torch.utils._pytree import tree_map

from grasptrajopt_tpu_torch.ops.constants import device_vector
from grasptrajopt_tpu_torch.ops.smallchol import (
    MAX_UNROLL_N,
    cholesky_small,
    cholesky_solve_small,
)


class LMConfig(NamedTuple):
    iterations: int = 50
    lambda_init: float = 1e-3
    lambda_decrease: float = 0.35
    lambda_increase: float = 4.0
    lambda_min: float = 1e-9
    lambda_max: float = 1e8
    jitter: float = 1e-9
    # trial step scales, evaluated together each iteration
    alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1, 0.03)


def make_box_lm_solver(
    residual_fn: Callable,
    config: LMConfig = LMConfig(),
    value_term: Optional[Tuple[Callable, Callable]] = None,
):
    """Build `solve(x0 (B, n), lo (n,), hi (n,), params, shared=None) ->
    (x, cost, aux)`.

    residual_fn(x (n,), params_b) -> (R,) for ONE problem; `params` holds
    per-problem tensors with leading dim B, `shared` tensors common to the
    batch (e.g. a packed field table).

    value_term = (value, value_and_grad), batch-level:
      value(x (B, ..., n), params, shared) -> (B, ...): the term at each
        problem's points (one per problem, or its (B, A) trial candidates);
      value_and_grad(x (B, n), params, shared) -> ((B,), (B, n)).
    """

    def solve(x0, lo, hi, params, shared=None):
        x = torch.minimum(torch.maximum(x0, lo), hi)
        B, n = x.shape
        eye = torch.eye(n, dtype=x.dtype, device=x.device)
        alphas = device_vector(config.alphas, x.dtype, x.device)

        def lin(xx, p):
            def f(v):
                r = residual_fn(v, p)
                return r, r

            return jacfwd(f, has_aux=True)(xx)

        def cost_one(xx, p):
            r = residual_fn(xx, p)
            return torch.sum(r * r)

        cand_cost = vmap(vmap(cost_one, in_dims=(0, None)), in_dims=(0, 0))
        c = vmap(cost_one)(x, params)
        if value_term is not None:
            value, value_and_grad = value_term
            c = c + value(x, params, shared)
        lam = torch.full((B,), config.lambda_init, dtype=x.dtype, device=x.device)
        for _ in range(config.iterations):
            J, r = vmap(lin)(x, params)  # (B, R, n), (B, R)
            c_now = torch.sum(r * r, dim=-1)
            g = torch.einsum("bri,br->bi", J, r)
            if value_term is not None:
                v, dv = value_and_grad(x, params, shared)
                c_now = c_now + v
                g = g + 0.5 * dv
            H = torch.einsum("bri,brj->bij", J, J)
            scale = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=config.jitter)
            A = H + lam[:, None, None] * torch.diag_embed(scale) + config.jitter * eye
            if n <= MAX_UNROLL_N:
                dx = -cholesky_solve_small(cholesky_small(A), g)
            else:
                # solve_ex: torch.linalg.solve's check of the result reads
                # it on the host; A is positive definite (lambda, jitter)
                dx = -torch.linalg.solve_ex(A, g)[0]

            cands = torch.minimum(
                torch.maximum(x[:, None] + alphas[None, :, None] * dx[:, None], lo), hi
            )  # (B, A, n)
            cand_costs = cand_cost(cands, params)  # (B, A)
            if value_term is not None:
                cand_costs = cand_costs + value(cands, params, shared)
            best = torch.argmin(cand_costs, dim=1)
            x_trial = cands[torch.arange(B, device=x.device), best]
            c_trial = cand_costs[torch.arange(B, device=x.device), best]
            step = x_trial - x
            pred = -2.0 * torch.sum(g * step, dim=-1) - torch.sum(
                step * (A @ step[..., None])[..., 0], dim=-1
            )
            actual = c_now - c_trial

            accept = (actual > 0.0) & torch.isfinite(c_trial)
            # the gain ratio only sets how fast lambda drops
            ratio = actual / torch.clamp(pred, min=1e-12)
            good = accept & (ratio > 0.25)
            x = torch.where(accept[:, None], x_trial, x)
            c = torch.where(accept, c_trial, c_now)
            lam = torch.where(
                good,
                lam * config.lambda_decrease,
                torch.where(accept, lam * 0.7, lam * config.lambda_increase),
            )
            lam = torch.clamp(lam, config.lambda_min, config.lambda_max)
        return x, c, {"lambda": lam}

    return solve


def solve_box_lm(residual_fn, x0, lo, hi, params, value_fn=None, config: LMConfig = LMConfig()):
    """One problem through `make_box_lm_solver` (a batch of one): x0 (n,),
    params as residual_fn(x, params) takes them. value_fn(x (n,), params)
    -> scalar, when given, is the term v. Returns (x (n,), cost (), aux)."""
    batched = tree_map(lambda a: a[None], params)
    value_term = None
    if value_fn is not None:
        value_grad = vmap(grad_and_value(value_fn))

        def value(x, p, shared):
            fn = value_fn
            if x.dim() == 3:  # (B, A, n): each problem's trial candidates
                fn = vmap(fn, in_dims=(0, None))
            return vmap(fn)(x, p)

        def value_and_grad(x, p, shared):
            dv, v = value_grad(x, p)
            return v, dv

        value_term = (value, value_and_grad)
    x, c, aux = make_box_lm_solver(residual_fn, config, value_term)(x0[None], lo, hi, batched)
    return x[0], c[0], {k: v[0] for k, v in aux.items()}
