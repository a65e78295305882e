"""GraspPipeline's stages in the port against the JAX package's, float64
robots (the synthetic arm and its gripper at 10 points per link, the
workspace grid at 10 cm) on one rendered observation (tabletop scene 10
at 64x64, the nearest object):

  - build_fields: both cost fields within 1e-6 (float32 clouds in both;
    the JAX CPU path's KD-tree against K1's plain version);
  - filter_grasps: the keep mask identical, on the object's grasps and on
    the same grasps lowered into the table;
  - screen_ik: multistart (8 seeds, 5 LM iterations, three grasps tiled to
    an IK capacity of 4) with the JAX package's restarts injected: q to
    1e-8, the found mask identical;
  - plan_object on goals out of reach: the 'no_ik' result, and on grasps
    all inside the table: 'no_collision_free_grasp'.
"""

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
    ik_capacity=4, ik_iterations=5, planner_iterations=3, planner_single_pass=True,
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
    return jp, pp, obs, jp.build_fields(*args), pp.build_fields(*args)


def test_build_fields(setup):
    _, pp, _, want, got = setup
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == torch.float32 and g.shape == (pp.robot.grid.size,)
        np.testing.assert_allclose(np_(g), np.asarray(w), atol=1e-6, rtol=0)
        assert np.asarray(w).max() > 0.0
    # the planning clouds are the returned obstacle cloud (one view)
    assert pp._plan_pc_obstacle is got[1]
    np.testing.assert_array_equal(np_(got[1].valid), np.asarray(want[1].valid))


def test_filter_grasps(setup):
    jp, pp, obs, want, got = setup
    RT = obs["grasps_world"]
    lowered = RT.copy()
    lowered[:, 2, 3] -= np.linspace(0.0, 0.2, len(RT))
    for grasps in (RT, lowered):
        keep = pp.filter_grasps(grasps, got[1])
        np.testing.assert_array_equal(keep, jp.filter_grasps(grasps, want[1]))
    assert keep.any() and not keep.all()


def test_screen_ik(setup):
    jp, pp, obs, want, _ = setup
    RT = obs["grasps_world"][:3].copy()
    RT[:, :3, 3] -= obs["base_position"]
    q, found = pp.screen_ik(QC, RT)
    qj, fj = jp.screen_ik(QC, RT, want[3], obs["base_position"])
    assert q.shape == (3, 9)
    np.testing.assert_allclose(q, qj, atol=1e-8, rtol=0)
    np.testing.assert_array_equal(found, fj)


def test_plan_object_early_stages(setup):
    jp, pp, obs, _, _ = setup
    args = (QC, obs["depth"], obs["K"], obs["cam_pose"], obs["target_mask"])
    far = obs["grasps_world"][:3].copy()
    far[:, :3, 3] += [3.0, 0.0, 2.0]  # free space out of the arm's reach
    buried = obs["grasps_world"][:3].copy()
    buried[:, 2, 3] = obs["base_position"][2] - 0.3  # under the table top
    for grasps, stage in ((far, "no_ik"), (buried, "no_collision_free_grasp")):
        got = pp.plan_object(*args, grasps, obs["base_position"])
        want = jp.plan_object(*args, grasps, obs["base_position"])
        assert got.stage == want.stage == stage
        assert got.plan is None and got.planning_time == 0.0
        assert (got.n_grasps, got.n_collision_free, got.n_ik_found) == (
            want.n_grasps, want.n_collision_free, want.n_ik_found
        )
