"""OptimizationBuilder: the problem-construction DSL.

Port of grasptrajopt_tpu/opt/builder.py. Per model and time derivative d
the builder allocates the decision block `{model}/{d*}q/x` of shape
(num_opt_joints, T - d) and the parameter block `{model}/{d*}q/p` of shape
(num_param_joints, T - d) (a TaskModel: `{model}/{d*}y/x` of (dim, T - d));
`derivs_align` gives every derivative T columns. Cost terms and
constraints are plain functions of (x, p), the dicts of named (rows, cols)
tensor blocks; `build()` assembles them into one `Optimization` whose
derivatives `torch.func` takes. The convenience constraints:
`initial_configuration`, `fix_configuration`, `integrate_model_states`
(explicit Euler), `enforce_model_limits` and
`sphere_collision_avoidance_constraints`.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from grasptrajopt_tpu_torch.models.robot import Model, RobotModel, TaskModel
from grasptrajopt_tpu_torch.opt.layout import BlockLayout
from grasptrajopt_tpu_torch.opt.taxonomy import Optimization


class OptimizationBuilder:
    def __init__(
        self,
        T: int,
        robots: Union[Sequence[RobotModel], RobotModel] = (),
        tasks: Union[Sequence[TaskModel], TaskModel] = (),
        derivs_align: bool = False,
        device="cuda",
    ):
        assert T > 0, "T must be strictly positive"
        if isinstance(robots, Model):
            robots = [robots]
        if isinstance(tasks, Model):
            tasks = [tasks]
        self.T = T
        self.derivs_align = derivs_align
        self.device = torch.device(device)
        self._models: List[Model] = list(robots) + list(tasks)
        names = [m.get_name() for m in self._models]
        assert len(names) == len(set(names)), "each model should have a unique name"

        self.x_layout = BlockLayout()
        self.p_layout = BlockLayout()
        self._cost_terms: List[tuple] = []  # (name, fn)
        self._eq: List[tuple] = []  # (name, fn) fn == 0
        self._ineq: List[tuple] = []  # (name, fn) fn >= 0

        for model in self._models:
            for d in model.time_derivs:
                t = T - d if not derivs_align else T
                if isinstance(model, RobotModel):
                    self.add_decision_variables(model.state_optimized_name(d), model.num_opt_joints, t)
                    self.add_parameter(model.state_parameter_name(d), model.num_param_joints, t)
                else:
                    self.add_decision_variables(
                        model.state_optimized_name(d), model.dim, t,
                        is_discrete=getattr(model, "is_discrete", False),
                    )

    def _const(self, v) -> torch.Tensor:
        """A constant of a cost or constraint as a float64 tensor on the
        builder's device (made once, not on every evaluation)."""
        return torch.as_tensor(v, dtype=torch.float64, device=self.device)

    # -- model access ---------------------------------------------------------

    def get_model_names(self) -> List[str]:
        return [m.get_name() for m in self._models]

    def get_model(self, name: str) -> Model:
        return self._models[self.get_model_names().index(name)]

    def get_model_states(self, x: dict, name: str, time_deriv: int = 0):
        """Decision-state block of a model from an x-dict (for use inside
        cost and constraint callables)."""
        model = self.get_model(name)
        assert time_deriv in model.time_derivs
        return x[model.state_optimized_name(time_deriv)]

    def get_model_parameters(self, p: dict, name: str, time_deriv: int = 0):
        model = self.get_model(name)
        return p[model.state_parameter_name(time_deriv)]

    def get_robot_states_and_parameters(self, x: dict, p: dict, name: str, time_deriv: int = 0):
        """The full (ndof, T - d) array: the optimized rows from x, the
        parameter rows from p, in joint order (one gather, no scatter)."""
        model = self.get_model(name)
        states = self.get_model_states(x, name, time_deriv)
        if model.num_param_joints:
            states = torch.cat([states, self.get_model_parameters(p, name, time_deriv)], dim=0)
        return states[model._assemble_perm]

    # -- variable/parameter/cost registration ---------------------------------

    def add_decision_variables(self, name: str, m: int, n: int = 1, is_discrete: bool = False) -> None:
        """Register an (m, n) decision block; is_discrete marks it
        integer-valued."""
        self.x_layout.add(name, m, n, discrete=is_discrete)

    def add_parameter(self, name: str, m: int, n: int = 1) -> None:
        self.p_layout.add(name, m, n)

    def add_cost_term(self, name: str, fn: Callable) -> None:
        """fn(x, p) -> scalar (or a tensor, summed)."""
        self._cost_terms.append((name, fn))

    def add_equality_constraint(self, name: str, fn: Callable) -> None:
        """fn(x, p) == 0 (any shape; flattened)."""
        self._eq.append((name, fn))

    def add_geq_inequality_constraint(self, name: str, fn: Callable) -> None:
        """fn(x, p) >= 0."""
        self._ineq.append((name, fn))

    def add_leq_inequality_constraint(self, name: str, fn: Callable) -> None:
        """fn(x, p) <= 0."""
        self._ineq.append((name, lambda x, p, f=fn: -f(x, p)))

    def add_bound_inequality_constraint(self, name: str, lo, fn: Callable, hi) -> None:
        """lo <= fn(x, p) <= hi."""
        lo = lo if isinstance(lo, torch.Tensor) else self._const(lo)
        hi = hi if isinstance(hi, torch.Tensor) else self._const(hi)
        self._ineq.append((name + "_lower", lambda x, p, f=fn: f(x, p) - lo))
        self._ineq.append((name + "_upper", lambda x, p, f=fn: hi - f(x, p)))

    # -- convenience constraints ----------------------------------------------

    def _pin(self, key: str, col: int, value, name: str) -> None:
        """x[key][:, col] == value: zeros when None, value(p) when
        callable, else the constant."""
        if value is not None and not callable(value):
            value = self._const(value)

        def fn(x, p):
            xt = x[key][:, col]
            if value is None:
                return xt
            if callable(value):
                return xt - value(p)
            return xt - value.to(xt.dtype)

        self.add_equality_constraint(name, fn)

    def initial_configuration(self, name: str, init=None, time_deriv: int = 0) -> None:
        """x[:, 0] == init (zeros when None)."""
        key = self.get_model(name).state_optimized_name(time_deriv)
        self._pin(key, 0, init, f"__{name}_initial_configuration_{time_deriv}__")

    def fix_configuration(self, name: str, config=None, time_deriv: int = 0, t: int = 0) -> None:
        """x[:, t] == config (zeros when None)."""
        key = self.get_model(name).state_optimized_name(time_deriv)
        self._pin(key, t, config, f"__{name}_fix_configuration_{time_deriv}_{t}__")

    def integrate_model_states(self, name: str, time_deriv: int, dt) -> None:
        """Explicit-Euler coupling x_{t+1} = x_t + dt * xd_t."""
        model = self.get_model(name)
        n = self.T - (1 if self.derivs_align else time_deriv)
        dt_arr = torch.broadcast_to(self._const(dt), (n,))
        xk = model.state_optimized_name(time_deriv - 1)
        xdk = model.state_optimized_name(time_deriv)

        def fn(x, p):
            xs = x[xk]
            xds = x[xdk]
            if self.derivs_align:
                xds = xds[:, :-1]
            return xs[:, :-1] + dt_arr.to(xs.dtype) * xds - xs[:, 1:]

        self.add_equality_constraint(f"__integrate_model_states_{name}_{time_deriv}__", fn)

    def enforce_model_limits(self, name: str, time_deriv: int = 0, lo=None, up=None, safe_frac: float = 1.0) -> None:
        """Box limits as bound inequality constraints; `safe_frac` shrinks
        the box about its middle."""
        assert 0.0 < safe_frac <= 1.0
        model = self.get_model(name)
        xlo, xup = lo, up
        if xlo is None or xup is None:
            mlo, mup = model.get_limits(time_deriv)
            xlo = mlo if xlo is None else xlo
            xup = mup if xup is None else xup
        xlo = np.asarray(xlo, dtype=np.float64).reshape(-1)
        xup = np.asarray(xup, dtype=np.float64).reshape(-1)
        if safe_frac < 1.0:
            mid = 0.5 * (xlo + xup)
            half = 0.5 * safe_frac * (xup - xlo)
            xlo, xup = mid - half, mid + half
        key = model.state_optimized_name(time_deriv)
        self.add_bound_inequality_constraint(
            f"__{name}_model_limit_{time_deriv}__",
            xlo[:, None],
            lambda x, p: x[key],
            xup[:, None],
        )

    def sphere_collision_avoidance_constraints(
        self,
        name: str,
        obstacle_names: Sequence[str],
        link_names: Optional[Sequence[str]] = None,
        link_radii: Optional[Sequence[float]] = None,
    ) -> None:
        """Sphere-vs-sphere separation: per link, per obstacle, per step,
        ||p_link - p_obs||^2 >= (r_link + r_obs)^2. Obstacle positions and
        radii become the parameters `{obs}_position` (3,) and
        `{obs}_radii` (1,)."""
        assert len(obstacle_names), "at least one obstacle should be named"
        model = self.get_model(name)
        assert isinstance(model, RobotModel)
        if link_names is None:
            link_names = model.link_names
        if link_radii is None:
            link_radii = [0.0] * len(link_names)
        for obs in obstacle_names:
            self.add_parameter(obs + "_position", 3)
            self.add_parameter(obs + "_radii", 1)

        def fn(x, p):
            Q = self.get_robot_states_and_parameters(x, p, name)
            out = []
            for link, rad in zip(link_names, link_radii):
                pos = model.get_global_link_position(link, Q.T)  # (T, 3)
                for obs in obstacle_names:
                    obs_p = p[obs + "_position"].reshape(3)
                    obs_r = p[obs + "_radii"].reshape(())
                    dist2 = torch.sum((pos - obs_p) ** 2, dim=-1)
                    out.append(dist2 - (rad + obs_r) ** 2)
            return torch.cat(out)

        self.add_geq_inequality_constraint(f"__{name}_sphere_collision_avoidance__", fn)

    # -- assembly -------------------------------------------------------------

    def build(self) -> Optimization:
        return Optimization(
            x_layout=self.x_layout,
            p_layout=self.p_layout,
            cost_terms=list(self._cost_terms),
            eq_constraints=list(self._eq),
            ineq_constraints=list(self._ineq),
            models=list(self._models),
            device=self.device,
        )
