"""GraspPipeline with the IK screen's collision term
(`ik_collision_avoidance=True`) against the JAX package's, float64, on one
rendered observation (tabletop scene 10 at 64x64; the synthetic arm and
its gripper at 10 points per link, the workspace grid at 10 cm, a 3 cm
field band): the object's first six grasps and the same six lowered 3 cm
toward the table, multistart (8 seeds, 20 LM iterations) with the JAX
package's restarts injected. Both screens read the JAX package's obstacle
field (the two field builds agree to 1e-6, tests/test_torch_pipeline_stages.py;
here the IK is held alone): q to 1e-8 and the found mask identical at the
default collision threshold and at one that gates on the term."""

import numpy as np
import pytest
import torch

from grasptrajopt_tpu.planning.pipeline import GraspPipeline as JaxPipeline
from grasptrajopt_tpu.testing import SYNTH_DEFAULT_POSE
from grasptrajopt_tpu_torch.planning.pipeline import GraspPipeline
from grasptrajopt_tpu_torch.testing import SYNTH_EVAL_CONFIG, make_synthetic_gripper
from torch_parity import (
    make_jax_synth_gripper,
    make_jax_synth_robot,
    np_,
    observation,
    port_robot,
    use_jax_restarts,
)

QC = SYNTH_DEFAULT_POSE.astype(np.float64)
KNOBS = dict(
    axis_standoff="z", gripper_open_offsets=SYNTH_EVAL_CONFIG["gripper_open_offsets"], goal_capacity=4,
    ik_iterations=20, planner_iterations=3, planner_single_pass=True, field_epsilon=0.03,
    ik_collision_avoidance=True,
)


@pytest.fixture(scope="module")
def setup():
    jr = make_jax_synth_robot(points_per_link=10, grid_resolution=0.1)
    pr = port_robot(jr)
    jp = JaxPipeline(jr, make_jax_synth_gripper(10), "hand", "hand", grid=jr.grid, **KNOBS)
    pp = GraspPipeline(
        pr, make_synthetic_gripper(device="cpu", dtype=torch.float64, points_per_link=10), "hand", "hand",
        grid=pr.grid, **KNOBS,
    )
    use_jax_restarts(pp.ik_solver, jr)
    obs = observation("tabletop", size=64)
    args = (obs["depth"], obs["K"], obs["cam_pose"], obs["target_mask"])
    want = jp.build_fields(*args)
    pp.build_fields(*args)
    RT = np.concatenate([obs["grasps_world"][:6]] * 2)
    RT[:, :3, 3] -= obs["base_position"]
    RT[6:, 2, 3] -= 0.03
    return jp, pp, obs, np.asarray(want[3]).astype(np.float64), RT


def test_screen_ik_with_collision_term(setup):
    jp, pp, obs, field, RT = setup
    base = obs["base_position"]
    _, _, _, col = pp.ik_solver.solve_ik_batch(
        torch.as_tensor(QC), torch.as_tensor(RT), field, base, multistart=True
    )
    assert (np_(col) > 1e-3).any()
    founds = []
    for threshold in (5.0, 1e-3):
        jp.ik_collision_threshold = pp.ik_collision_threshold = threshold
        q, found = pp.screen_ik(QC, RT, field, base)
        qj, fj = jp.screen_ik(QC, RT, field, base)
        np.testing.assert_allclose(q, np.asarray(qj), atol=1e-8, rtol=0)
        np.testing.assert_array_equal(found, np.asarray(fj))
        founds.append(found)
    # the lower threshold drops a grasp that is reached but whose pose collides
    assert founds[1].any() and (founds[0] & ~founds[1]).any() and not (founds[1] & ~founds[0]).any()
    # the term moves the screen's solutions
    pp.ik_solver.collision_avoidance = False
    pp.ik_solver.setup_optimization()
    try:
        q_free, _ = pp.screen_ik(QC, RT)
    finally:
        pp.ik_solver.collision_avoidance = True
        pp.ik_solver.setup_optimization()
    assert np.abs(q_free - q).max() > 1e-3
