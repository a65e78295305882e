"""GraspPipeline.plan_object with rescue=False in the port against the
JAX package's: the synthetic arm and its gripper (10 points per link,
float64, the workspace grid at 10 cm), tabletop scene 10 at 64x64 (the
nearest object, its first 4 grasps), the bench's planner flavour (3
iterations, single pass, coarse 2+1, final_trust) at T = 12. Both
pipelines get the same IK screen (the port's, injected), so the file
compiles one JAX solver. The plan agrees to 1e-6 (the float32 fields
differ by float32 rounding), with the interpolated warm start and with
the shelf's constant-qc one."""

import numpy as np
import pytest
import torch

from grasptrajopt_tpu.planning.gto_planner import GTOPlanner as JaxPlanner
from grasptrajopt_tpu.planning.pipeline import GraspPipeline as JaxPipeline
from grasptrajopt_tpu.testing import SYNTH_DEFAULT_POSE
from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner
from grasptrajopt_tpu_torch.planning.pipeline import GraspPipeline
from grasptrajopt_tpu_torch.testing import SYNTH_EVAL_CONFIG, make_synthetic_gripper
from torch_parity import make_jax_synth_gripper, make_jax_synth_robot, observation, port_robot

QC = SYNTH_DEFAULT_POSE.astype(np.float64)
T = 12
FLAVOUR = dict(iterations=3, single_pass=True, coarse_iterations=2, final_trust=True)
KNOBS = dict(
    axis_standoff="z", gripper_open_offsets=SYNTH_EVAL_CONFIG["gripper_open_offsets"], goal_capacity=4,
    ik_capacity=4, standoff_offset=-4, rescue=False,
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
    jp.planner = JaxPlanner(jr, "hand", "hand", standoff_offset=-4, T=T, **FLAVOUR)
    pp.planner = GTOPlanner(pr, "hand", "hand", standoff_offset=-4, T=T, **FLAVOUR)
    obs = observation("tabletop", size=64)
    RT = obs["grasps_world"][:4]
    RT_base = RT.copy()
    RT_base[:, :3, 3] -= obs["base_position"]
    q, _ = pp.screen_ik(QC, RT_base)
    found = np.ones(4, dtype=bool)
    pp.screen_ik = lambda *a: (q, found)
    jp.screen_ik = lambda *a: (q, found)
    return jp, pp, obs, RT


@pytest.mark.parametrize("interpolate", [True, False])
def test_plan_object_matches_jax(setup, interpolate):
    jp, pp, obs, RT = setup
    jp.interpolate = pp.interpolate = interpolate
    args = (QC, obs["depth"], obs["K"], obs["cam_pose"], obs["target_mask"], RT, obs["base_position"])
    got, want = pp.plan_object(*args), jp.plan_object(*args)
    assert got.stage == want.stage == "ok"
    assert (got.n_grasps, got.n_collision_free, got.n_ik_found) == (
        want.n_grasps, want.n_collision_free, want.n_ik_found
    )
    assert not (got.rescued or got.escalated)
    assert got.plan.shape == (9, T)
    np.testing.assert_allclose(got.plan, want.plan, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.dQ, want.dQ, atol=1e-5, rtol=0)
    assert abs(got.cost - float(want.cost)) <= 1e-6 * (1 + abs(float(want.cost)))
    assert not np.allclose(got.plan[:, -1], QC)  # the plan moved
