"""Minimal IK demo: solve a planar 3-DoF reach with the LM solver on the
device and cross-check it against SciPy SLSQP; needs no data.

Port of examples/planar_ik.py. Run on the card (or `--device cpu`):

    python -m grasptrajopt_tpu_torch.planar_ik
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from grasptrajopt_tpu_torch.models import RobotModel
from grasptrajopt_tpu_torch.opt import solve_box_lm
from grasptrajopt_tpu_torch.opt.lm import LMConfig
from grasptrajopt_tpu_torch.opt.scipy_oracle import solve_scipy_box

PLANAR_3DOF = """
<robot name="planar_3dof">
  <link name="base"/><link name="l1"/><link name="l2"/><link name="ee"/>
  <joint name="j1" type="revolute">
    <parent link="base"/><child link="l1"/><origin xyz="0 0 0"/>
    <axis xyz="0 0 1"/><limit lower="-3.14" upper="3.14" velocity="1"/>
  </joint>
  <joint name="j2" type="revolute">
    <parent link="l1"/><child link="l2"/><origin xyz="1 0 0"/>
    <axis xyz="0 0 1"/><limit lower="-3.14" upper="3.14" velocity="1"/>
  </joint>
  <joint name="j3" type="revolute">
    <parent link="l2"/><child link="ee"/><origin xyz="1 0 0"/>
    <axis xyz="0 0 1"/><limit lower="-3.14" upper="3.14" velocity="1"/>
  </joint>
</robot>
"""
TARGET = (1.2, 0.9, 0.0)
REACH_TOL = 1e-4


def solve(device="cuda"):
    """Both solutions of the reach: {"lm": (q, cost), "slsqp": (q, cost),
    "reached": the LM solution's end-effector position, "reached_slsqp":
    SLSQP's} as host numpy."""
    robot = RobotModel(urdf_string=PLANAR_3DOF, dtype=torch.float64, device=device)
    target = torch.tensor(TARGET, dtype=torch.float64, device=robot.device)

    def residual(q, p):
        return robot.get_global_link_position("ee", q) - p

    lo = torch.full((3,), -3.14, dtype=torch.float64, device=robot.device)
    hi = -lo
    x0 = torch.full((3,), 0.1, dtype=torch.float64, device=robot.device)
    q_lm, c_lm, _ = solve_box_lm(residual, x0, lo, hi, target, config=LMConfig(iterations=50))
    q_sp, c_sp = solve_scipy_box(
        residual, np.full(3, 0.1), lo.cpu().numpy(), hi.cpu().numpy(), target, device=robot.device
    )
    reached = robot.get_global_link_position("ee", q_lm)
    reached_sp = robot.get_global_link_position("ee", torch.as_tensor(q_sp, dtype=torch.float64, device=robot.device))
    return {
        "lm": (q_lm.cpu().numpy(), float(c_lm)),
        "slsqp": (q_sp, c_sp),
        "reached": reached.cpu().numpy(),
        "reached_slsqp": reached_sp.cpu().numpy(),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    out = solve(args.device)
    print("LM solution:   ", out["lm"][0], "cost", out["lm"][1])
    print("SLSQP solution:", out["slsqp"][0], "cost", out["slsqp"][1])
    print("reached:", out["reached"], "target:", np.asarray(TARGET))
    err = float(np.linalg.norm(out["reached"] - np.asarray(TARGET)))
    if not err < REACH_TOL:
        raise AssertionError(f"the LM solution misses the target by {err:.3e} (limit {REACH_TOL})")
    return out


if __name__ == "__main__":
    main()
