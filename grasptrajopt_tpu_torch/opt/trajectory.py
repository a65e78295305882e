"""Block-tridiagonal projected Levenberg-Marquardt over a batch of
trajectories.

Port of grasptrajopt_tpu/opt/trajectory.py: the two-pass iteration (one
linearisation, then a candidate ladder evaluated in one batched pass and
a gain-ratio damping update), the single-pass ("delayed gratification")
iteration with the coarse phase, `final_trust` and the post-scan
evaluation, and the KKT step by the Thomas recursion or by cyclic
reduction. The decision variable of each problem is
X = q[nf:T] (the first nf steps are pinned to qc); box limits are a
clip; the velocity regularizer is a smoothness term of weight w; the
Gauss-Newton Hessian is block-tridiagonal and solved exactly per
iteration.

Batch-first: every problem of the batch runs the same iteration schedule
with its own damping and accept decisions, exactly as the JAX package's
`vmap` of one solve. The per-step residual is written for ONE step of ONE
problem and is mapped with `torch.func.vmap` over problems and steps; its
Jacobian comes from `torch.func.jacfwd(has_aux=True)` (primal and tangents
from one trace). The whole-trajectory term and the pre-iteration hook are
batch-first. The solve runs in full precision: callers on the card keep
TF32 off.

Under `torch.profiler` each solve records its spans
(`utils.profiling.span`): `solve` around the whole solve, `lm.iteration`
around each iteration (its `index` and `coarse` flag), and inside it
`lm.residuals` (the per-step residuals' Jacobians, GN blocks and
gradient), `lm.field_term` (the whole-trajectory term's) and `lm.kkt`
(the damped blocks and the KKT solve).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd, vmap

from grasptrajopt_tpu_torch.ops.block_tridiag import (
    block_tridiag_matvec,
    block_tridiag_solve,
    block_tridiag_solve_cr,
)
from grasptrajopt_tpu_torch.ops.constants import device_vector
from grasptrajopt_tpu_torch.utils.profiling import span


class TrajectoryConfig(NamedTuple):
    T: int  # total trajectory steps
    n_fixed: int = 2  # leading steps pinned to qc (q_0 = q_1 = qc)
    smooth_weight: float = 0.0  # w = vel_weight / dt^2
    iterations: int = 50
    lambda_init: float = 1e-3
    lambda_decrease: float = 0.35
    lambda_increase: float = 4.0
    lambda_min: float = 1e-9
    lambda_max: float = 1e8
    jitter: float = 1e-9
    # trial step scales of the two-pass iteration, all evaluated in one
    # batched residual pass
    alphas: Tuple[float, ...] = (1.0,)
    # single_pass=True: one residual/jac pass per iteration, the pass at
    # the trial point being its acceptance test; the (H, g) of the last
    # accepted point are carried so a rejected trial re-solves from them
    single_pass: bool = False
    # final_trust=True (single_pass only) skips the post-scan residual
    # pass: the budget's final KKT trial point is returned unevaluated,
    # with the cost of the last accepted point
    final_trust: bool = False
    # cyclic_reduction=True: the KKT step by block cyclic reduction
    # (log2 T batched levels) instead of the Thomas recursion
    cyclic_reduction: bool = False


def make_trajectory_solver(
    step_residual_fn: Callable,
    config: TrajectoryConfig,
    pre_iteration: Optional[Callable] = None,
    traj_term: Optional[Tuple[Callable, Callable]] = None,
    coarse: Optional[Tuple[int, Tuple[Callable, Callable]]] = None,
):
    """Build `solve(qc_opt, X0, lo, hi, params, shared) -> (Q, cost, aux)`.

    qc_opt (B, n); X0 (B, T-nf, n); lo / hi (n,). `params` is a dict of
    per-problem tensors, each with leading dim B; `shared` a dict of
    tensors common to the batch (e.g. a stacked field table).

    step_residual_fn(q (n,), t (), step_aux, params_b) -> (R,): residuals
      of ONE step of ONE problem; `t` is a tensor, so per-step behavior
      switches with torch.where. params_b is the problem's slice of params.
    pre_iteration(Q (B, T, n), params, shared) -> step_aux (B, ...):
      per-iteration state (the active goal), frozen during the step.
    traj_term = (value_fn, value_jac_fn), batch-first whole-trajectory
      residuals: value_fn(Q, step_aux, params, shared) -> (B, T, R2);
      value_jac_fn -> ((B, T, R2), (B, T, R2, n)), the Jacobian at step t
      w.r.t. q_t only.
    coarse = (k, traj_term_coarse): the first k iterations run with the
      coarse whole-trajectory term in place of traj_term; the fine phase
      restarts the accepted-cost state and carries lambda (single pass
      only).

    Returns Q (B, T, n) including the pinned prefix, cost (B,), and
    {"lambda": (B,), "accepts": (B, iterations) bool, "step_aux": (B, ...)}.
    """
    T = config.T
    nf = config.n_fixed
    F = T - nf
    w = config.smooth_weight
    kkt_solve = block_tridiag_solve_cr if config.cyclic_reduction else block_tridiag_solve

    if coarse is not None:
        if not config.single_pass:
            raise NotImplementedError("coarse phase requires single_pass=True")
        k_coarse, term_coarse = int(coarse[0]), coarse[1]
        if not 0 <= k_coarse < config.iterations:
            raise ValueError(
                f"coarse iterations {k_coarse} must be in [0, {config.iterations})"
            )
    else:
        k_coarse = 0

    def assemble(X, qc_opt):
        prefix = qc_opt[:, None, :].expand(-1, nf, -1)
        return torch.cat([prefix, X], dim=1)  # (B, T, n)

    def smooth_cost(Q):
        dq = Q[:, 1:] - Q[:, :-1]
        return w * torch.sum(dq * dq, dim=(1, 2))

    def smooth_grad_X(Q):
        """d(smooth_cost)/dX / 2 (the g = grad/2 convention)."""
        inner = 2.0 * Q[:, nf:-1] - Q[:, nf - 1 : -2] - Q[:, nf + 1 :]
        last = Q[:, -1] - Q[:, -2]
        return w * torch.cat([inner, last[:, None]], dim=1)

    def step_values(Q, t_all, step_aux, params, step_fn):
        per_step = vmap(step_fn, in_dims=(0, 0, None, None))
        return vmap(per_step, in_dims=(0, None, 0, 0))(Q, t_all, step_aux, params)

    def residuals_cost(X, qc_opt, step_aux, params, shared, step_fn, term):
        """One full residual pass: total cost (B,) only."""
        Q = assemble(X, qc_opt)
        t_all = torch.arange(T, device=Q.device)
        r = step_values(Q, t_all, step_aux, params, step_fn)
        c = torch.sum(r * r, dim=(1, 2)) + smooth_cost(Q)
        if term is not None:
            r2 = term[0](Q, step_aux, params, shared)
            c = c + torch.sum(r2 * r2, dim=(1, 2))
        return c

    def solve(qc_opt, X0, lo, hi, params, shared=None):
        with span("solve", device=qc_opt.device):
            return solve_spanned(qc_opt, X0, lo, hi, params, shared)

    def solve_spanned(qc_opt, X0, lo, hi, params, shared):
        shared = shared or {}
        B, n = qc_opt.shape
        dtype, dev = qc_opt.dtype, qc_opt.device
        X0 = torch.minimum(torch.maximum(X0.to(dtype), lo), hi)
        eye = torch.eye(n, dtype=dtype, device=dev)
        t_all = torch.arange(T, device=dev)
        # 2, ..., 2, 1 by fills: a host constant would synchronize the stream
        vel_diag = torch.full((F,), 2.0, dtype=dtype, device=dev)
        vel_diag[F - 1:].fill_(1.0)
        vel_diag = w * vel_diag  # (F,)
        L_off = (-w * eye).expand(B, F - 1, n, n)

        def step_lin(q, t, aux, p, step_fn):
            def f(qq):
                r = step_fn(qq, t, aux, p)
                return r, r

            J, r = jacfwd(f, has_aux=True)(q)  # (R, n), (R,)
            return r, J

        def lin_at(X, step_aux, step_fn, term):
            """One jacfwd pass at X: cost (B,), GN blocks H (B, F, n, n),
            gradient g (B, F, n)."""
            with span("lm.residuals"):
                Q = assemble(X, qc_opt)
                per_step = vmap(lambda q, t, a, p: step_lin(q, t, a, p, step_fn),
                                in_dims=(0, 0, None, None))
                r_all, J_all = vmap(per_step, in_dims=(0, None, 0, 0))(
                    Q, t_all, step_aux, params
                )  # (B, T, R), (B, T, R, n)
                c = torch.sum(r_all * r_all, dim=(1, 2)) + smooth_cost(Q)
                Jt = J_all[:, nf:]
                H = torch.einsum("bfri,bfrj->bfij", Jt, Jt)
                g = torch.einsum("bfri,bfr->bfi", Jt, r_all[:, nf:]) + smooth_grad_X(Q)
            if term is not None:
                with span("lm.field_term"):
                    r2, J2 = term[1](Q, step_aux, params, shared)  # (B,T,R2), (B,T,R2,n)
                    c = c + torch.sum(r2 * r2, dim=(1, 2))
                    H = H + torch.einsum("bfri,bfrj->bfij", J2[:, nf:], J2[:, nf:])
                    g = g + torch.einsum("bfri,bfr->bfi", J2[:, nf:], r2[:, nf:])
            return c, H, g

        def damped_D(H, lam):
            """LM-damped diagonal blocks (Marquardt scaling + jitter)."""
            diagH = torch.diagonal(H, dim1=-2, dim2=-1)  # (B, F, n)
            scale = torch.clamp(diagH + vel_diag[:, None], min=config.jitter)
            return (
                H
                + vel_diag[:, None, None] * eye
                + lam[:, None, None, None] * torch.diag_embed(scale)
                + config.jitter * eye
            )

        def solve_from(H, g, lam):
            with span("lm.kkt"):
                return -kkt_solve(damped_D(H, lam), L_off, g)

        def pick(accept, a, b):
            return torch.where(accept.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

        def iteration_two(state):
            """Two-pass iteration: linearise at X, solve the damped KKT
            system, evaluate every candidate X + alpha dX in ONE batched
            residual pass, accept the best if it lowers the cost; the gain
            ratio against the GN model sets how fast lambda drops."""
            X, lam, _, aux_prev = state
            step_aux = (
                pre_iteration(assemble(X, qc_opt), params, shared)
                if pre_iteration is not None
                else aux_prev
            )
            c_now, H, g = lin_at(X, step_aux, step_residual_fn, traj_term)
            with span("lm.kkt"):
                D = damped_D(H, lam)
                dX = -kkt_solve(D, L_off, g)
            cands = torch.minimum(
                torch.maximum(X[:, None] + alphas[None, :, None, None] * dX[:, None], lo), hi
            )  # (B, A, F, n)
            cand_costs = residuals_cost(
                cands.reshape((B * A,) + X.shape[1:]), qc_opt_c,
                step_aux.repeat_interleave(A, dim=0), params_c, shared, step_residual_fn, traj_term,
            ).reshape(B, A)
            best = torch.argmin(cand_costs, dim=1)
            rows = torch.arange(B, device=dev)
            X_trial, c_trial = cands[rows, best], cand_costs[rows, best]
            step = X_trial - X  # the projected step
            Hs = block_tridiag_matvec(D, L_off, step)
            pred = -2.0 * torch.sum(g * step, dim=(1, 2)) - torch.sum(step * Hs, dim=(1, 2))
            actual = c_now - c_trial
            accept = (actual > 0.0) & torch.isfinite(c_trial)
            good = accept & (actual / torch.clamp(pred, min=1e-12) > 0.25)
            lam_new = torch.clamp(
                torch.where(
                    good, lam * config.lambda_decrease,
                    torch.where(accept, lam * 0.7, lam * config.lambda_increase),
                ),
                config.lambda_min,
                config.lambda_max,
            )
            return (pick(accept, X_trial, X), lam_new, torch.where(accept, c_trial, c_now), step_aux), accept

        def iteration_single(state, step_fn, term):
            """ONE residual/jac pass per iteration: the pass at the trial
            point is its acceptance test; on reject, re-solve from the
            stored (H, g) of the accepted point with a larger lambda."""
            X_try, X_acc, H_acc, g_acc, c_acc, lam, aux_prev = state
            step_aux = (
                pre_iteration(assemble(X_try, qc_opt), params, shared)
                if pre_iteration is not None
                else aux_prev
            )
            c_try, H_try, g_try = lin_at(X_try, step_aux, step_fn, term)
            accept = (c_try < c_acc) & torch.isfinite(c_try)
            X_base = pick(accept, X_try, X_acc)
            H_base = pick(accept, H_try, H_acc)
            g_base = pick(accept, g_try, g_acc)
            c_base = torch.where(accept, c_try, c_acc)
            lam_new = torch.clamp(
                torch.where(accept, lam * config.lambda_decrease, lam * config.lambda_increase),
                config.lambda_min,
                config.lambda_max,
            )
            dX = solve_from(H_base, g_base, lam_new)
            X_next = torch.minimum(torch.maximum(X_base + dX, lo), hi)
            return (X_next, X_base, H_base, g_base, c_base, lam_new, step_aux), accept

        aux0 = (
            pre_iteration(assemble(X0, qc_opt), params, shared)
            if pre_iteration is not None
            else torch.zeros(B, dtype=torch.long, device=dev)
        )
        lam0 = torch.full((B,), config.lambda_init, dtype=dtype, device=dev)
        accepts = []
        if not config.single_pass:
            alphas = device_vector(config.alphas, dtype, dev)
            A = alphas.shape[0]
            # the candidate ladder rides the batch dimension: problem b's
            # candidate a is row b * A + a of one residual pass
            params_c = {k: v.repeat_interleave(A, dim=0) for k, v in params.items()}
            qc_opt_c = qc_opt.repeat_interleave(A, dim=0)
            c0 = residuals_cost(X0, qc_opt, aux0, params, shared, step_residual_fn, traj_term)
            state = (X0, lam0, c0, aux0)
            for i in range(config.iterations):
                with span("lm.iteration", index=i, coarse=False):
                    state, acc = iteration_two(state)
                accepts.append(acc)
            X, lam, c, step_aux = state
            return assemble(X, qc_opt), c, {
                "lambda": lam, "accepts": torch.stack(accepts, dim=1), "step_aux": step_aux,
            }

        big = torch.full((B,), float("inf"), dtype=dtype, device=dev)
        H0 = torch.zeros((B, F, n, n), dtype=dtype, device=dev)
        g0 = torch.zeros((B, F, n), dtype=dtype, device=dev)
        state = (X0, X0, H0, g0, big, lam0, aux0)
        if k_coarse:
            for i in range(k_coarse):
                with span("lm.iteration", index=i, coarse=True):
                    state, acc = iteration_single(state, step_residual_fn, term_coarse)
                accepts.append(acc)
            _, X_acc_c, _, _, _, lam_c, aux_c = state
            state = (X_acc_c, X_acc_c, H0, g0, big, lam_c, aux_c)
        for i in range(k_coarse, config.iterations):
            with span("lm.iteration", index=i, coarse=False):
                state, acc = iteration_single(state, step_residual_fn, traj_term)
            accepts.append(acc)
        X_try, X_acc, _, _, c_acc, lam, step_aux = state
        diag = {"lambda": lam, "accepts": torch.stack(accepts, dim=1)}
        if config.final_trust:
            return assemble(X_try, qc_opt), c_acc, {**diag, "step_aux": step_aux}
        # post-scan pass: keep the budget's final trial point if it improves
        if pre_iteration is not None:
            aux_try = pre_iteration(assemble(X_try, qc_opt), params, shared)
        else:
            aux_try = step_aux
        c_try = residuals_cost(
            X_try, qc_opt, aux_try, params, shared, step_residual_fn, traj_term
        )
        take = (c_try < c_acc) & torch.isfinite(c_try)
        X_fin = pick(take, X_try, X_acc)
        c_fin = torch.where(take, c_try, c_acc)
        step_aux = pick(take, aux_try, step_aux)
        return assemble(X_fin, qc_opt), c_fin, {**diag, "step_aux": step_aux}

    return solve
