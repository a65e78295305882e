"""Solver interfaces over built Optimization problems.

Port of grasptrajopt_tpu/opt/solver.py. The abstract Solver keeps the
initial seed and the parameters as flat float64 vectors on the problem's
device and speaks the block-dict ABI: `reset_initial_seed` /
`reset_parameters` take dicts of named blocks (numpy arrays or tensors),
and `solve` returns a dict of numpy blocks with the parameter joints
merged back into the full `{name}/q` trajectories, plus "f". Diagnostics:
`violated_constraints`, `evaluate_cost(_terms)`, `stats`, `did_solve`,
`interpolate`.

Backends:
  ALSQPSolver  — the augmented-Lagrangian NLP solver on the device, with a
                 relax -> round -> polish pass for discrete variables
  ADMMQPSolver — ADMM for quadratic problems on the device
  ScipyMinimizeSolver — SciPy on the host, with the cost, constraints and
                 their derivatives evaluated on the problem's device
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from scipy import interpolate as sci_interp
from scipy import optimize as sci_opt
from torch.func import grad

from grasptrajopt_tpu_torch.models.robot import RobotModel
from grasptrajopt_tpu_torch.opt.al_sqp import ALSQPConfig, make_al_sqp_solver
from grasptrajopt_tpu_torch.opt.qp import ADMMConfig, solve_qp_admm
from grasptrajopt_tpu_torch.opt.taxonomy import Optimization


class Solver:
    def __init__(self, optimization: Optimization, error_on_fail: bool = False):
        self.opt = optimization
        self.error_on_fail = error_on_fail
        self.device = optimization.device
        self._x0 = torch.zeros(optimization.nx, dtype=torch.float64, device=self.device)
        self._p = torch.zeros(optimization.np_, dtype=torch.float64, device=self.device)
        self._stats: Dict = {}

    def _vec(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=torch.float64, device=self.device)

    # -- seeding / parameters (block-dict ABI) --------------------------------

    def _reset(self, layout, current, values: Dict) -> torch.Tensor:
        full = layout.unvec(current)
        for k, v in values.items():
            full[k] = self._vec(v).reshape(layout.shapes[k])
        return layout.vec(full, torch.float64, self.device)

    def reset_initial_seed(self, values: Dict) -> None:
        self._x0 = self._reset(self.opt.x_layout, self._x0, values)

    def reset_parameters(self, values: Dict) -> None:
        self._p = self._reset(self.opt.p_layout, self._p, values)

    # -- solve ----------------------------------------------------------------

    def _solve_vec(self) -> torch.Tensor:
        raise NotImplementedError

    def solve(self) -> Dict:
        xvec = self._solve_vec()
        solution = {k: v.cpu().numpy() for k, v in self.opt.x_layout.unvec(xvec).items()}
        pdict = self.opt.p_layout.unvec(self._p)
        # merge the parameter joints back into the full `{name}/q` arrays
        for model in self.opt.models:
            if not isinstance(model, RobotModel):
                for d in getattr(model, "time_derivs", []):
                    solution[model.state_name(d)] = solution[model.state_optimized_name(d)]
                continue
            for d in model.time_derivs:
                states = solution[model.state_optimized_name(d)]
                full = np.zeros((model.dim, states.shape[1]))
                full[model.optimized_joint_indexes] = states
                if model.num_param_joints:
                    full[model.parameter_joint_indexes] = pdict[model.state_parameter_name(d)].cpu().numpy()
                solution[model.state_name(d)] = full
        solution["f"] = float(self.opt.f(xvec, self._p))
        self._xsol = xvec
        return solution

    # -- diagnostics ----------------------------------------------------------

    def _point(self, xvec, pvec):
        return (self._xsol if xvec is None else self._vec(xvec),
                self._p if pvec is None else self._vec(pvec))

    def evaluate_cost(self, xvec=None, pvec=None) -> float:
        return float(self.opt.f(*self._point(xvec, pvec)))

    def evaluate_cost_terms(self, xvec=None, pvec=None) -> Dict[str, float]:
        return {k: float(v) for k, v in self.opt.cost_term_values(*self._point(xvec, pvec)).items()}

    def violated_constraints(self, xvec=None, pvec=None, tol: float = 1e-6) -> Dict[str, float]:
        """{constraint name: its largest violation} over those violated by
        more than `tol`."""
        xvec, pvec = self._point(xvec, pvec)
        x = self.opt.x_layout.unvec(xvec)
        p = self.opt.p_layout.unvec(pvec)
        out: Dict[str, float] = {}
        for name, fn in self.opt.eq_constraints:
            viol = float(torch.max(torch.abs(torch.as_tensor(fn(x, p)))))
            if viol > tol:
                out[name] = viol
        for name, fn in self.opt.ineq_constraints:
            viol = float(-torch.min(torch.as_tensor(fn(x, p))))
            if viol > tol:
                out[name] = viol
        return out

    def stats(self) -> Dict:
        return self._stats

    def did_solve(self, tol: float = 1e-5) -> bool:
        return not self.violated_constraints(tol=tol)

    def number_of_iterations(self) -> Optional[int]:
        return self._stats.get("iterations")

    @staticmethod
    def interpolate(traj: np.ndarray, duration: float, **kwargs):
        """Trajectory (dim, T) -> callable over [0, duration]."""
        traj = np.asarray(traj)
        t = np.linspace(0.0, duration, traj.shape[1])
        return sci_interp.interp1d(t, traj, axis=1, **kwargs)


class ALSQPSolver(Solver):
    """General NLP backend: the augmented-Lagrangian solver (opt/al_sqp.py)."""

    def setup(self, lo=None, hi=None, config: ALSQPConfig = ALSQPConfig()) -> "ALSQPSolver":
        opt = self.opt
        self._solver = make_al_sqp_solver(
            opt.f,
            h=opt.h if opt.eq_constraints else None,
            g=opt.g if opt.ineq_constraints else None,
            config=config,
        )
        self._lo = self._vec(np.full(opt.nx, -np.inf) if lo is None else lo)
        self._hi = self._vec(np.full(opt.nx, np.inf) if hi is None else hi)
        return self

    def _solve_vec(self):
        x, info = self._solver(self._x0, self._lo, self._hi, self._p)
        if self.opt.has_discrete_variables:
            # relax -> round the discrete coordinates -> polish the
            # continuous ones with the discrete ones pinned by their box
            mask = torch.as_tensor(self.opt.discrete_mask(), device=self.device)
            x_round = torch.where(mask, torch.round(x), x)
            x_round = torch.minimum(torch.maximum(x_round, self._lo), self._hi)
            lo2 = torch.where(mask, x_round, self._lo)
            hi2 = torch.where(mask, x_round, self._hi)
            x, info = self._solver(x_round, lo2, hi2, self._p)
        self._stats = {
            "constraint_violation": float(info["constraint_violation"]),
            "f": float(info["f"]),
        }
        return x


class ADMMQPSolver(Solver):
    """Quadratic-problem backend: ADMM (opt/qp.py)."""

    def setup(self, config: ADMMConfig = ADMMConfig()) -> "ADMMQPSolver":
        self._config = config
        return self

    def _solve_vec(self):
        assert self.opt.cost_is_quadratic(), "ADMMQPSolver requires a quadratic cost"
        assert self.opt.constraints_are_linear(), "ADMMQPSolver requires linear constraints"
        P, q, A, l, u = self.opt.as_qp(self._p)
        x, z, y, res = solve_qp_admm(P, q, A, l, u, x0=self._x0, config=self._config)
        self._stats = {k: float(v) for k, v in res.items()}
        self._stats["iterations"] = self._config.iterations
        return x


class ScipyMinimizeSolver(Solver):
    """SciPy backend on the host (SLSQP by default); the cost, the
    constraints and their derivatives are evaluated on the problem's
    device."""

    def setup(self, method: str = "SLSQP", maxiter: int = 500) -> "ScipyMinimizeSolver":
        self._method = method
        self._maxiter = maxiter
        return self

    def _solve_vec(self):
        opt = self.opt
        p = self._p
        df = grad(opt.f)

        def host(fn):
            return lambda xx: fn(self._vec(xx), p).cpu().numpy().astype(float)

        cons = []
        if opt.eq_constraints:
            cons.append({"type": "eq", "fun": host(opt.h), "jac": host(opt.dh)})
        if opt.ineq_constraints:
            cons.append({"type": "ineq", "fun": host(opt.g), "jac": host(opt.dg)})
        res = sci_opt.minimize(
            lambda xx: float(opt.f(self._vec(xx), p)),
            self._x0.cpu().numpy().astype(float),
            jac=host(df),
            constraints=cons,
            method=self._method,
            options={"maxiter": self._maxiter, "ftol": 1e-12},
        )
        self._stats = {"iterations": res.nit, "success": bool(res.success), "message": res.message}
        if self.error_on_fail and not res.success:
            raise RuntimeError(f"scipy solve failed: {res.message}")
        return self._vec(res.x)
