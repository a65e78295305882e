"""The per-goal solve's field branch (the rescue tier, at the main
planner's flavor: coarse 2+1, final_trust) against the JAX package's
plan_pergoal_batch in float64 on the CPU, on the problem of
pergoal_parity.py with the synthetic tabletop field. The points branch
is test_torch_points_plan.py; tolerances are in pergoal_parity.py."""

import numpy as np

from grasptrajopt_tpu.testing import make_synthetic_scene_field
from pergoal_parity import check_against_jax, problem, run_jax, run_port
from torch_parity import make_jax_synth_robot, port_robot


def test_pergoal_field_mode_matches_jax():
    jr = make_jax_synth_robot(points_per_link=10)
    obs, tf_goal, q_sols, sets = problem()
    f_all = make_synthetic_scene_field(jr, seed=0).astype(np.float64)
    fields = (f_all, 0.5 * f_all)
    Qp, cp, aux = run_port(port_robot(jr), "field", obs, tf_goal, q_sols, sets, fields=fields)
    check_against_jax(Qp[0], cp[0], aux, run_jax(jr, "field", obs, tf_goal, q_sols, fields=fields))
