"""The port's TOPP retiming (`planning/retiming.py`, a host numpy / scipy
copy) against the JAX package's: the three cases of
tests/test_utils.py::TestRetiming on the port, and both packages'
`toppra_retime` / `convert_plan_to_trajectory` on seeded plans at the
synthetic arm's velocity limits, equal bit for bit (the same numpy code);
a plan given as a tensor is brought to the host."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grasptrajopt_tpu.planning import retiming as jax_retiming
from grasptrajopt_tpu.testing import SYNTH_DEFAULT_POSE
from grasptrajopt_tpu.testing import make_synthetic_gto_robot as jax_synth
from grasptrajopt_tpu_torch.planning.retiming import convert_plan_to_trajectory, toppra_retime
from grasptrajopt_tpu_torch.planning.utils import interpolate_waypoints
from grasptrajopt_tpu_torch.testing import make_synthetic_gto_robot as port_synth


class _FakeRobot:
    def __init__(self, ndof, vmax=1.0):
        self.velocity_optimized_joint_limits = np.full(ndof, vmax)
        self.velocity_actuated_joint_limits = np.full(ndof, vmax)


class TestRetiming:
    def test_limits_respected(self):
        T = 20
        plan = np.stack([np.linspace(0, 1.0, T), np.linspace(0, -0.5, T)])
        robot = _FakeRobot(2, vmax=0.8)
        qs, qds, qdds, ts = convert_plan_to_trajectory(robot, plan, accel_limit=0.5)
        assert qs.shape == (100, 2)
        assert ts[0] == 0.0 and ts[-1] > 0
        np.testing.assert_allclose(qs[0], plan[:, 0], atol=1e-3)
        np.testing.assert_allclose(qs[-1], plan[:, -1], atol=1e-3)
        assert np.abs(qds).max() <= 0.8 * 1.05
        assert np.percentile(np.abs(qdds), 90) <= 0.5 * 1.2
        assert np.abs(qdds).max() <= 0.5 * 2.0

    def test_rest_to_rest(self):
        T = 15
        plan = np.stack([np.linspace(0, 0.5, T)])
        qs, qds, qdds, ts = convert_plan_to_trajectory(_FakeRobot(1), plan)
        np.testing.assert_allclose(qds[0], 0.0, atol=1e-2)
        np.testing.assert_allclose(qds[-1], 0.0, atol=1e-2)

    def test_faster_limits_shorter_duration(self):
        T = 15
        plan = np.stack([np.linspace(0, 1.0, T)])
        _, _, _, ts_slow = convert_plan_to_trajectory(_FakeRobot(1, vmax=0.5), plan)
        _, _, _, ts_fast = convert_plan_to_trajectory(_FakeRobot(1, vmax=2.0), plan)
        assert ts_fast[-1] < ts_slow[-1]


@pytest.fixture(scope="module")
def robots():
    return jax_synth(dtype=jnp.float64, points_per_link=1), port_synth(device="cpu", dtype=torch.float64, points_per_link=1)


def seeded_plans(robot, n=4, T=50):
    """n smooth plans (7, T) of the synthetic arm's optimized joints from
    its default pose to seeded targets within the joint limits."""
    rng = np.random.default_rng(11)
    lo, hi = robot.lower_optimized_joint_limits, robot.upper_optimized_joint_limits
    qc = torch.as_tensor(SYNTH_DEFAULT_POSE[:7])
    out = []
    for _ in range(n):
        target = torch.as_tensor(np.clip(SYNTH_DEFAULT_POSE[:7] + rng.normal(scale=0.6, size=7), lo, hi))
        out.append(interpolate_waypoints(qc, target, T).T.numpy())
    return out


def test_both_packages_retime_synth7_plans_identically(robots):
    jr, pr = robots
    np.testing.assert_array_equal(pr.velocity_optimized_joint_limits, np.asarray(jr.velocity_optimized_joint_limits))
    vmax = pr.velocity_optimized_joint_limits
    for plan in seeded_plans(pr):
        for accel, samples in ((0.5, 100), (2.0, 60)):
            got = convert_plan_to_trajectory(pr, plan, accel_limit=accel, num_samples=samples)
            want = jax_retiming.convert_plan_to_trajectory(jr, plan, accel_limit=accel, num_samples=samples)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            qs, qds, _, ts = got
            assert qs.shape == (samples, 7) and ts[-1] > 0
            np.testing.assert_allclose(qs[0], plan[:, 0], atol=1e-3)
            np.testing.assert_allclose(qs[-1], plan[:, -1], atol=1e-3)
            assert (np.abs(qds) <= 1.05 * vmax).all()
        path, s, x = toppra_retime(plan, vmax, np.full(7, 0.5), grid_points=150)
        path_j, s_j, x_j = jax_retiming.toppra_retime(plan, vmax, np.full(7, 0.5), grid_points=150)
        np.testing.assert_array_equal(s, s_j)
        np.testing.assert_array_equal(x, x_j)
        np.testing.assert_array_equal(path(s), path_j(s_j))


def test_a_tensor_plan_is_brought_to_the_host(robots):
    _, pr = robots
    plan = seeded_plans(pr, n=1)[0]
    vmax, alims = pr.velocity_optimized_joint_limits, np.full(7, 0.5)
    for tensor in (torch.as_tensor(plan), torch.as_tensor(plan, dtype=torch.float32)):
        host = tensor.numpy().astype(np.float64)
        for a, b in zip(convert_plan_to_trajectory(pr, tensor), convert_plan_to_trajectory(pr, host)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(toppra_retime(tensor, vmax, alims)[2], toppra_retime(host, vmax, alims)[2])
