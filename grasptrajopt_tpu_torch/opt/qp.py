"""Batched ADMM QP solver (OSQP-style splitting), batch-first.

Port of grasptrajopt_tpu/opt/qp.py for quadratic problems

    min 1/2 x^T P x + q^T x    s.t.    l <= A x <= u

with a fixed iteration count:
    x+ = (P + sigma I + rho A^T A)^{-1} (sigma x - q + A^T (rho z - y))
    z+ = clip(A x+ + y / rho, l, u)        (over-relaxed by alpha)
    y+ = y + rho (A x+ - z+)
The matrix is factorized once (Cholesky) and each iteration solves with
two triangular solves. Every argument may carry the same leading batch
dimensions: a batch of QPs is one call (the JAX package vmaps one).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ADMMConfig(NamedTuple):
    iterations: int = 200
    rho: float = 1.0
    sigma: float = 1e-6
    alpha: float = 1.6  # over-relaxation


def _mv(M, v):
    """(..., r, c) @ (..., c) -> (..., r)."""
    return (M @ v[..., None])[..., 0]


def solve_qp_admm(P, q, A, l, u, x0=None, config: ADMMConfig = ADMMConfig()):
    """P (..., n, n), q (..., n), A (..., m, n), l / u (..., m), x0 (..., n)
    or None (zeros). Returns (x, z, y, residuals dict of (...,) tensors)."""
    n = q.shape[-1]
    m = l.shape[-1]
    dtype, dev = P.dtype, P.device
    rho, sigma, alpha = config.rho, config.sigma, config.alpha
    At = A.mT

    K = P + sigma * torch.eye(n, dtype=dtype, device=dev) + rho * (At @ A)
    chol = torch.linalg.cholesky(K)
    chol_t = chol.mT

    def kkt_solve(b):
        yv = torch.linalg.solve_triangular(chol, b[..., None], upper=False)
        return torch.linalg.solve_triangular(chol_t, yv, upper=True)[..., 0]

    x = torch.zeros_like(q) if x0 is None else torch.as_tensor(x0, dtype=dtype, device=dev).expand(q.shape)
    z = _mv(A, x)
    y = torch.zeros_like(l)
    for _ in range(config.iterations):
        x = kkt_solve(sigma * x - q + _mv(At, rho * z - y))
        Ax_relaxed = alpha * _mv(A, x) + (1 - alpha) * z
        z_new = torch.minimum(torch.maximum(Ax_relaxed + y / rho, l), u)
        y = y + rho * (Ax_relaxed - z_new)
        z = z_new

    if m:
        primal_res = torch.amax(torch.abs(_mv(A, x) - z), dim=-1)
        dual_res = torch.amax(torch.abs(_mv(P, x) + q + _mv(At, y)), dim=-1)
    else:
        primal_res = torch.zeros(q.shape[:-1], dtype=dtype, device=dev)
        dual_res = torch.amax(torch.abs(_mv(P, x) + q), dim=-1)
    return x, z, y, {"primal_res": primal_res, "dual_res": dual_res}
