"""The solves build their constants on the device, with no copy from host
memory (on a CUDA device each such copy synchronizes the stream, so the
host can no longer run ahead of the card).

Each repaired expression gives bit for bit the values of the
`torch.tensor(..., device=...)` expression it replaced (restated here),
in float32 and float64; and a bench solve, a served solve, the IK screen,
the rescue tier's per-goal batch, the base planner's LM and the sharded
bench step make no `torch.tensor` / `torch.as_tensor` call with a
`device` inside the solve."""

import collections
import contextlib
import dataclasses
import os
import traceback
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parity  # noqa: F401  (one intra-op thread)
from grasptrajopt_tpu_torch import bench as pb
from grasptrajopt_tpu_torch import parallel
from grasptrajopt_tpu_torch import throughput_serving as serving
from grasptrajopt_tpu_torch.models.robot import RobotModel
from grasptrajopt_tpu_torch.ops import interp
from grasptrajopt_tpu_torch.ops.constants import device_vector
from grasptrajopt_tpu_torch.opt.lm import LMConfig
from grasptrajopt_tpu_torch.opt.trajectory import TrajectoryConfig
from grasptrajopt_tpu_torch.parallel import mesh as port_mesh
from grasptrajopt_tpu_torch.planning.base_planner import BasePlanner
from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner
from grasptrajopt_tpu_torch.planning.ik_solver import IKSolver
from grasptrajopt_tpu_torch.planning.utils import interpolate_waypoints
from grasptrajopt_tpu_torch.spatial import rt2tr, standoff
from grasptrajopt_tpu_torch.testing import (
    SYNTH_DEFAULT_POSE,
    SYNTH_LINK_EE,
    SYNTH_LINK_GRIPPER,
    make_synthetic_goal,
    make_synthetic_gto_robot,
    make_synthetic_scene_field,
)

DTYPES = (torch.float32, torch.float64)


def same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# -- the repaired expressions against the ones they replaced ------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_rt2tr_bottom_row(dtype):
    g = torch.Generator().manual_seed(0)
    R = torch.randn((5, 3, 3, 3), generator=g, dtype=dtype)
    t = torch.randn((5, 3, 3), generator=g, dtype=dtype)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros((5, 3, 1, 4), dtype=dtype) + torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype)
    assert same_bits(rt2tr(R, t), torch.cat([top, bottom], dim=-2))


@pytest.mark.parametrize("dtype", DTYPES)
def test_fk_frames(dtype):
    robot = make_synthetic_gto_robot(device="cpu", dtype=dtype, points_per_link=2)
    q = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (4, 6, robot.ndof)), dtype=dtype)
    comps = robot.fk_components(q)
    for f in range(len(robot.kinematics.frame_names)):
        AR, At = comps
        rows = [torch.stack([AR[i][0][..., f], AR[i][1][..., f], AR[i][2][..., f], At[i][..., f]], dim=-1)
                for i in range(3)]
        bottom = torch.zeros_like(rows[0]) + torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype)
        assert same_bits(RobotModel.frame_matrix(comps, f), torch.stack(rows + [bottom], dim=-2))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("F", [1, 2, 48, 198])
def test_vel_diag(dtype, F):
    """opt/trajectory.py's KKT diagonal weights, w x (2, ..., 2, 1)."""
    w = TrajectoryConfig(T=F + 2, smooth_weight=0.1 / 0.2**2).smooth_weight
    old = w * torch.where(torch.arange(F) < F - 1, torch.tensor(2.0, dtype=dtype), torch.tensor(1.0, dtype=dtype))
    new = torch.full((F,), 2.0, dtype=dtype)
    new[F - 1:].fill_(1.0)
    assert same_bits(w * new, old)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("values", [LMConfig().alphas, TrajectoryConfig(T=50).alphas, (0.1, 1 / 3, 2e-7, -7.25, 1e30),
                                    (0.4, -0.65, 1.35)])
def test_device_vector_rounds_as_torch_tensor(dtype, values):
    assert same_bits(device_vector(values, dtype, "cpu"), torch.tensor(values, dtype=dtype))


def _grid_points(dtype, lead, lo, hi, seed):
    g = torch.Generator().manual_seed(seed)
    return lo + torch.rand(lead, generator=g, dtype=dtype) * (hi - lo)


@pytest.mark.parametrize("dtype", DTYPES)
def test_clamped_offsets_and_cells(dtype):
    """ops/interp.py's three clamps, with points inside and beyond the
    grid on every side."""
    shape, res = (7, 5, 9), 0.05
    origin = torch.tensor([-0.2, 0.1, 0.3], dtype=dtype)
    pts = _grid_points(dtype, (6, 40, 3), origin - 0.2, origin + torch.tensor(shape, dtype=dtype) * res + 0.2, 2)

    u = (pts - origin) / res
    idx = torch.minimum(torch.clamp(torch.floor(u).to(torch.long), min=0),
                        torch.tensor([shape[0] - 1, shape[1] - 1, shape[2] - 1]))
    old = idx[..., 2] + shape[2] * (idx[..., 1] + shape[1] * idx[..., 0])
    assert same_bits(interp.points_to_offsets(pts, origin, shape, res), old)

    base_old = torch.minimum(torch.clamp(torch.floor(u).to(torch.long), min=0),
                             torch.tensor([shape[0] - 2, shape[1] - 2, shape[2] - 2]))
    base, frac = interp._base_and_frac(pts, origin, shape, res)
    assert same_bits(base, base_old)
    assert same_bits(frac, torch.clamp(u - base_old.to(dtype), 0.0, 1.0))

    shape2 = (11, 4)
    xy = pts[..., :2]
    idx2 = torch.minimum(torch.clamp(torch.floor((xy - origin[:2]) / res).to(torch.int32), min=0),
                         torch.tensor([shape2[0] - 1, shape2[1] - 1], dtype=torch.int32))
    assert same_bits(interp.points_to_offsets_2d(xy, origin[:2], shape2, res), idx2[..., 1] + shape2[1] * idx2[..., 0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 10, 48, 198])
def test_interpolate_waypoints(dtype, n):
    g = torch.Generator().manual_seed(n)
    qc, qs = torch.rand(9, generator=g, dtype=dtype), torch.rand((5, 9), generator=g, dtype=dtype)
    t = torch.linspace(0.0, 1.0, n + 2, dtype=torch.float64)[1:-1].to(dtype)
    s = 3.0 * t**2 - 2.0 * t**3
    assert same_bits(interpolate_waypoints(qc, qs, n), qc + s[:, None] * (qs - qc)[..., None, :])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_standoff(dtype, axis):
    old = torch.eye(4, dtype=dtype)
    old[{"x": 0, "y": 1, "z": 2}[axis], 3] = -0.1
    assert same_bits(standoff(-0.1, axis, dtype), old)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lm_solve_ex(dtype):
    """opt/lm.py solves its n > MAX_UNROLL_N systems with solve_ex: the
    same factorization as torch.linalg.solve, without its check."""
    g = torch.Generator().manual_seed(0)
    J = torch.randn((4, 40, 31), generator=g, dtype=dtype)
    A = J.transpose(1, 2) @ J + 1e-3 * torch.eye(31, dtype=dtype)
    b = torch.randn((4, 31), generator=g, dtype=dtype)
    assert same_bits(torch.linalg.solve_ex(A, b)[0], torch.linalg.solve(A, b))


@pytest.mark.parametrize("dtype", DTYPES)
def test_grid_origin_tensor(dtype):
    robot = make_synthetic_gto_robot(device="cpu", dtype=dtype, points_per_link=2)
    assert same_bits(robot.grid.origin_tensor(dtype, "cpu"), torch.tensor(robot.grid.origin, dtype=dtype))


# -- no host constant inside a solve -------------------------------------------


@contextlib.contextmanager
def device_constants():
    """Records (file:line of the port's innermost frame) every
    torch.tensor / torch.as_tensor call that passes a device."""
    calls = collections.Counter()
    wrapped = {}

    def wrap(name):
        orig = getattr(torch, name)

        def call(*args, **kwargs):
            if "device" in kwargs:
                ours = [f for f in traceback.extract_stack()[:-1]
                        if f"{os.sep}grasptrajopt_tpu_torch{os.sep}" in f.filename]
                where = ours[-1] if ours else traceback.extract_stack()[-2]
                calls[f"torch.{name} at {os.path.basename(where.filename)}:{where.lineno}"] += 1
            return orig(*args, **kwargs)

        wrapped[name] = call

    for name in ("tensor", "as_tensor"):
        wrap(name)
    with mock.patch.object(torch, "tensor", wrapped["tensor"]), mock.patch.object(torch, "as_tensor",
                                                                                 wrapped["as_tensor"]):
        yield calls


@pytest.fixture(scope="module")
def robot():
    return make_synthetic_gto_robot(device="cpu", dtype=torch.float64, points_per_link=3)


def assert_no_device_constants(fn):
    fn()  # a warm-up: set-up that a first call caches is not inside the solve
    with device_constants() as calls:
        fn()
    assert not calls, f"device constants inside the solve: {dict(calls)}"


@pytest.fixture
def quick_warm_start(monkeypatch):
    """The bench's warm start (an IK screen, set-up outside the timed
    solve) replaced by holding qc: the solve is what these tests watch."""

    def hold(robot, ik, qc, tf_goal, T, seed=0, restarts=None):
        B = tf_goal.shape[0]
        X0 = robot.extract_optimized_dimensions(qc).expand(B, T, -1).contiguous()
        return X0, torch.zeros(B, dtype=torch.long)

    monkeypatch.setattr(pb, "warm_start", hold)


@pytest.mark.parametrize("flavour", sorted(pb.FLAVOURS))
def test_bench_solve(robot, flavour, quick_warm_start):
    cfg = dataclasses.replace(pb.FLAVOURS[flavour], batch=2, goal_capacity=2,
                              T=20 if flavour == "long_horizon" else 12)
    bench = pb.SolveBench(robot, cfg)
    assert_no_device_constants(bench.step)


def test_served_solve():
    server = serving.Server(iterations=2, goals=2, device="cpu", dtype=torch.float64, points_per_link=3)
    request = server.request(0, 2)
    assert_no_device_constants(lambda: server.solve(*request))


@pytest.mark.parametrize("collision", [False, True])
def test_ik_screen(robot, collision):
    """The slice's IK screen (tensor inputs), with and without its
    collision term."""
    ik = IKSolver(robot, SYNTH_LINK_EE, SYNTH_LINK_GRIPPER, collision_avoidance=collision, iterations=3)
    qc = torch.as_tensor(SYNTH_DEFAULT_POSE, dtype=torch.float64)
    goals = torch.as_tensor(np.stack([make_synthetic_goal(i) for i in range(3)]), dtype=torch.float64)
    field = torch.as_tensor(make_synthetic_scene_field(robot), dtype=torch.float64)
    base = torch.zeros(3, dtype=torch.float64)
    args = (field, base) if collision else ()
    assert_no_device_constants(lambda: ik.solve_ik_batch(qc, goals, *args, multistart=True))


def test_pergoal_rescue_solve(robot):
    """The rescue tier's per-goal batch (seed trajectories from each
    goal's IK solution, the stacked table) on tensor inputs."""
    planner = GTOPlanner(robot, SYNTH_LINK_EE, SYNTH_LINK_GRIPPER, iterations=2, single_pass=True,
                         coarse_iterations=1, final_trust=True, T=12)
    field = torch.as_tensor(make_synthetic_scene_field(robot), dtype=torch.float64)
    fields = planner.pack_stacked_fields(field[None], field[None])
    qc = torch.as_tensor(SYNTH_DEFAULT_POSE, dtype=torch.float64)
    tf_goal = torch.as_tensor(np.stack([make_synthetic_goal(i) for i in range(2)]), dtype=torch.float64)[None]
    q_sol = qc.expand(1, 2, -1).contiguous()
    n_goals = torch.full((1,), 2)
    base = torch.zeros(3, dtype=torch.float64)
    assert_no_device_constants(lambda: planner.plan_pergoal_batch(qc, tf_goal, n_goals, q_sol, base, fields=fields))


def test_base_solve(robot):
    """The base planner's LM (31 variables: the solve_ex path) on its
    device problem."""
    bp = BasePlanner(robot, SYNTH_LINK_EE, SYNTH_LINK_GRIPPER, iterations=3)
    x0, params, _ = bp._problems(SYNTH_DEFAULT_POSE, np.stack([make_synthetic_goal(i) for i in range(4)])[None])
    assert_no_device_constants(lambda: bp._solve(x0, params))


def test_sharded_bench_step(robot, tmp_path, monkeypatch, quick_warm_start):
    for k in port_mesh.CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    assert parallel.distributed_init(coordinator=f"file://{tmp_path}/store", device="cpu")
    try:
        bench = pb.ShardedSolveBench(robot, pb.SolveBenchConfig(batch=2, goal_capacity=2, T=12),
                                     parallel.data_mesh(1))
        assert_no_device_constants(bench.step)
    finally:
        dist.destroy_process_group()
