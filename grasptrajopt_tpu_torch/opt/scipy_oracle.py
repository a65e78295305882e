"""SciPy oracle: solve a box-constrained least-squares NLP with
scipy.optimize on the host (float64), the cost and its gradient evaluated
by torch on the problem's device.

Port of grasptrajopt_tpu/opt/scipy_oracle.py: the cross-check of the
on-device LM solvers (`planar_ik` solves its IK both ways).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from scipy import optimize
from torch.func import grad


def solve_scipy_box(
    residual_fn: Callable,
    x0: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    params,
    value_fn: Optional[Callable] = None,
    method: str = "SLSQP",
    maxiter: int = 200,
    device="cuda",
):
    """Minimize sum(r^2) + v over a box; r = residual_fn(x, params) and
    v = value_fn(x, params) take x as a float64 (n,) tensor on `device`.
    Returns (x (n,) numpy, cost)."""

    def cost(x, p):
        r = residual_fn(x, p)
        c = torch.sum(r * r)
        if value_fn is not None:
            c = c + value_fn(x, p)
        return c

    cost_grad = grad(cost)

    def tensor(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)

    res = optimize.minimize(
        lambda x: float(cost(tensor(x), params)),
        np.asarray(x0, dtype=np.float64),
        jac=lambda x: cost_grad(tensor(x), params).cpu().numpy().astype(np.float64),
        bounds=list(zip(np.asarray(lo, dtype=float), np.asarray(hi, dtype=float))),
        method=method,
        options={"maxiter": maxiter, "ftol": 1e-12},
    )
    return res.x, float(res.fun)
