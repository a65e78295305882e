"""Optimization: the assembled problem object.

Port of grasptrajopt_tpu/opt/taxonomy.py. One object holds
  f(x, p)             cost (sum of named terms)
  h(x, p) = 0         stacked equality constraints
  g(x, p) >= 0        stacked inequality constraints
over flat (nx,) / (np,) vectors, with derivatives by `torch.func`
(df: grad, ddf: hessian, dh / dg: jacfwd) and the stacked view
v = [g; h; -h] >= 0.

Problems are classified numerically: the cost is quadratic when its
Hessian agrees at two probe points, the constraints linear when their
Jacobians do. The probe points come from `np.random.default_rng(seed)` in
float64, the JAX package's draws, so both packages classify alike.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd

from grasptrajopt_tpu_torch.opt.layout import BlockLayout


def _tensor(v, like: torch.Tensor) -> torch.Tensor:
    """`v` as a tensor (a callable may return a Python number)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


@dataclass
class Optimization:
    x_layout: BlockLayout
    p_layout: BlockLayout
    cost_terms: List[Tuple[str, Callable]]
    eq_constraints: List[Tuple[str, Callable]]
    ineq_constraints: List[Tuple[str, Callable]]
    models: List = field(default_factory=list)
    device: torch.device = field(default_factory=lambda: torch.device("cuda"))

    # -- scalar cost and stacked constraints over flat vectors ---------------

    @property
    def nx(self) -> int:
        return self.x_layout.size

    @property
    def np_(self) -> int:
        return self.p_layout.size

    def f(self, xvec, pvec):
        x = self.x_layout.unvec(xvec)
        p = self.p_layout.unvec(pvec)
        total = torch.zeros((), dtype=xvec.dtype, device=xvec.device)
        for _, fn in self.cost_terms:
            total = total + _tensor(fn(x, p), xvec).sum()
        return total

    def cost_term_values(self, xvec, pvec) -> Dict[str, torch.Tensor]:
        x = self.x_layout.unvec(xvec)
        p = self.p_layout.unvec(pvec)
        return {name: _tensor(fn(x, p), xvec).sum() for name, fn in self.cost_terms}

    def _stack(self, constraints, xvec, pvec):
        x = self.x_layout.unvec(xvec)
        p = self.p_layout.unvec(pvec)
        parts = [_tensor(fn(x, p), xvec).reshape(-1) for _, fn in constraints]
        return torch.cat(parts) if parts else torch.zeros(0, dtype=xvec.dtype, device=xvec.device)

    def h(self, xvec, pvec):
        """Stacked equalities (== 0)."""
        return self._stack(self.eq_constraints, xvec, pvec)

    def g(self, xvec, pvec):
        """Stacked inequalities (>= 0)."""
        return self._stack(self.ineq_constraints, xvec, pvec)

    def v(self, xvec, pvec):
        """Verticalized constraints [g; h; -h] >= 0."""
        hv = self.h(xvec, pvec)
        return torch.cat([self.g(xvec, pvec), hv, -hv])

    def df(self, xvec, pvec):
        return grad(self.f)(xvec, pvec)

    def ddf(self, xvec, pvec):
        return hessian(self.f)(xvec, pvec)

    def dh(self, xvec, pvec):
        return jacfwd(self.h)(xvec, pvec)

    def dg(self, xvec, pvec):
        return jacfwd(self.g)(xvec, pvec)

    # -- classification (numeric probing) ------------------------------------

    def _probe_points(self, seed: int = 0, count: int = 2):
        rng = np.random.default_rng(seed)
        xs = [torch.as_tensor(rng.normal(size=self.nx), dtype=torch.float64, device=self.device)
              for _ in range(count)]
        pv = torch.as_tensor(rng.normal(size=self.np_), dtype=torch.float64, device=self.device)
        return xs, pv

    def cost_is_quadratic(self) -> bool:
        """Constant Hessian at two probe points (exact for polynomial
        costs)."""
        xs, pv = self._probe_points()
        H0 = self.ddf(xs[0], pv).cpu().numpy()
        H1 = self.ddf(xs[1], pv).cpu().numpy()
        return bool(np.allclose(H0, H1, atol=1e-9))

    def constraints_are_linear(self) -> bool:
        xs, pv = self._probe_points(seed=1)
        for deriv in (self.dh, self.dg):
            J0 = deriv(xs[0], pv).cpu().numpy()
            J1 = deriv(xs[1], pv).cpu().numpy()
            if not np.allclose(J0, J1, atol=1e-9):
                return False
        return True

    # -- discrete (integer) decision variables --------------------------------

    @property
    def has_discrete_variables(self) -> bool:
        return self.x_layout.has_discrete_variables()

    def discrete_mask(self) -> np.ndarray:
        """(nx,) bool mask over the flat decision vector."""
        return self.x_layout.discrete_mask()

    @property
    def problem_class(self) -> str:
        """{MixedInteger}{Quadratic|Nonlinear}Cost{Unconstrained|
        LinearConstraints|NonlinearConstraints}."""
        quad = self.cost_is_quadratic()
        has_con = bool(self.eq_constraints or self.ineq_constraints)
        lin = self.constraints_are_linear() if has_con else True
        cost = "QuadraticCost" if quad else "NonlinearCost"
        prefix = "MixedInteger" if self.has_discrete_variables else ""
        if not has_con:
            return prefix + cost + "Unconstrained"
        return prefix + cost + ("LinearConstraints" if lin else "NonlinearConstraints")

    # -- QP materialization ---------------------------------------------------

    def as_qp(self, pvec):
        """P, q, A, l, u of a quadratic problem: the cost's Hessian and
        gradient and the constraints' Jacobians and values at x = 0;
        inequalities get the upper bound 1e20."""
        zero = torch.zeros(self.nx, dtype=torch.float64, device=self.device)
        P = self.ddf(zero, pvec)
        q = self.df(zero, pvec)
        A_g = self.dg(zero, pvec)
        b_g = self.g(zero, pvec)
        A_h = self.dh(zero, pvec)
        b_h = self.h(zero, pvec)
        big = 1e20
        A = torch.cat([A_g, A_h], dim=0)
        l = torch.cat([-b_g, -b_h])
        u = torch.cat([torch.full_like(b_g, big), -b_h])
        return P, q, A, l, u
