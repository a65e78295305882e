"""Planners: robot surface model, IK screen, goal-set trajectory planner
(`planning.gto_planner`, which imports `convert` and so is not imported
here), mobile-base placement."""

from grasptrajopt_tpu_torch.planning.gto_models import GTORobotModel
from grasptrajopt_tpu_torch.planning.ik_solver import IKSolver
from grasptrajopt_tpu_torch.planning.base_planner import BasePlanner

__all__ = ["GTORobotModel", "IKSolver", "BasePlanner"]
