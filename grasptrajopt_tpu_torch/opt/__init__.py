"""Optimization core: the batched solvers of the planners (trajectory LM,
box-constrained LM) and the builder stack for problems stated by the user:
the block layout, `OptimizationBuilder`, `Optimization`, the
augmented-Lagrangian NLP solver, the ADMM QP solver and the `Solver`
backends (port of grasptrajopt_tpu/opt)."""

from grasptrajopt_tpu_torch.opt.lm import make_box_lm_solver, solve_box_lm
from grasptrajopt_tpu_torch.opt.trajectory import (
    TrajectoryConfig,
    make_trajectory_solver,
)
from grasptrajopt_tpu_torch.opt.layout import BlockLayout
from grasptrajopt_tpu_torch.opt.builder import OptimizationBuilder
from grasptrajopt_tpu_torch.opt.taxonomy import Optimization
from grasptrajopt_tpu_torch.opt.al_sqp import ALSQPConfig, make_al_sqp_solver
from grasptrajopt_tpu_torch.opt.qp import ADMMConfig, solve_qp_admm
from grasptrajopt_tpu_torch.opt.solver import (
    ADMMQPSolver,
    ALSQPSolver,
    ScipyMinimizeSolver,
    Solver,
)

__all__ = [
    "make_box_lm_solver",
    "solve_box_lm",
    "TrajectoryConfig",
    "make_trajectory_solver",
    "BlockLayout",
    "OptimizationBuilder",
    "Optimization",
    "ALSQPConfig",
    "make_al_sqp_solver",
    "ADMMConfig",
    "solve_qp_admm",
    "Solver",
    "ALSQPSolver",
    "ADMMQPSolver",
    "ScipyMinimizeSolver",
]
