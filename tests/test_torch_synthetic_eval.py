"""The closed-loop harness of the port (grasptrajopt_tpu_torch.synthetic_eval)
against the JAX package's (examples/synthetic_eval.py) on tabletop scene
10, its two nearest objects, at 48x48: the synthetic arm and its gripper
(10 points per link, float64, the workspace grid at 10 cm), goal capacity
12 (each object has 10 grasps), the bench's planner flavour (3 iterations, single pass, coarse 2+1,
final_trust).

Both IK screens draw the JAX package's multistart restarts, and run 10 LM
iterations instead of 50: at 20 and more several restarts reach a goal to
~1e-33 and the winner among them is rounding noise (tests/
test_torch_multistart.py). Rewards, stages, the grasp counts, the rescued
and escalated flags and the scorer's verdicts are identical; errors and
plans agree to 1e-5. The result round-trips through the port's
aggregate_results as through the JAX package's.

The file takes 150-160 s alone on a CPU: the JAX harness compiles its IK
screen (about 20 s) for each trial and its goal-set plan and rescue
(about 45-50 s each) once. One trial a file would repeat those compiles
(about 140 s a file), so both trials stay here; test_torch_pipeline_{stages,
plan,tiers}.py hold the same stages to the JAX package at smaller cost."""

import json

import numpy as np
import pytest
import torch

from examples import synthetic_eval as jax_eval
from grasptrajopt_tpu.planning.ik_solver import IKSolver as JaxIK
from grasptrajopt_tpu.utils.results import aggregate_results as jax_aggregate
from grasptrajopt_tpu_torch import synthetic_eval
from grasptrajopt_tpu_torch.planning.ik_solver import IKSolver
from grasptrajopt_tpu_torch.testing import SYNTH_EVAL_CONFIG, make_synthetic_gripper
from grasptrajopt_tpu_torch.utils.results import aggregate_results, load_results
from torch_parity import make_jax_synth_gripper, make_jax_synth_robot, port_robot, use_jax_restarts

IK_ITERATIONS = 10
RUN = dict(
    scene_type="tabletop", scene_ids=[10], n_objects=2, width=48, height=48, goal_capacity=12, iterations=3,
    single_pass=True, coarse_iterations=2, final_trust=True, orderings=["nearest_first"], verbose=False,
)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    jr = make_jax_synth_robot(points_per_link=10, grid_resolution=0.1)
    jg = make_jax_synth_gripper(10)
    pr = port_robot(jr)
    pg = make_synthetic_gripper(device="cpu", dtype=torch.float64, points_per_link=10)
    mp = pytest.MonkeyPatch()
    try:
        for cls in (JaxIK, IKSolver):
            init = cls.__init__

            def fewer_iterations(self, *a, _init=init, **k):
                _init(self, *a, **k)
                self.iterations = IK_ITERATIONS
            mp.setattr(cls, "__init__", fewer_iterations)
        port_init = IKSolver.__init__

        def with_jax_restarts(self, *a, **k):
            port_init(self, *a, **k)
            use_jax_restarts(self, jr)
        mp.setattr(IKSolver, "__init__", with_jax_restarts)
        path = str(tmp_path_factory.mktemp("eval") / "result.json")
        got = synthetic_eval.evaluate_scenes(pr, pg, dict(SYNTH_EVAL_CONFIG), checkpoint_path=path, **RUN)
        want = jax_eval.evaluate_scenes(jr, jg, dict(SYNTH_EVAL_CONFIG), **RUN)
    finally:
        mp.undo()
    return got, want, path


def test_trial_outcomes_match_jax(results):
    got, want, _ = results
    g, w = got["10"]["nearest_first"], want["10"]["nearest_first"]
    assert list(g) == list(w) and len(g) == 2
    for name in g:
        a, b = g[name], w[name]
        assert set(a) == set(b), name
        for k in ("reward", "stage", "num_grasps", "num_collision_free", "num_ik", "rescued", "escalated",
                  "reached", "collision", "max_inside_points"):
            assert a.get(k) == b.get(k), (name, k)
        assert a["stage"] == "ok"
        for k in ("err_pos", "err_rot"):
            assert abs(a[k] - b[k]) <= 1e-5, (name, k)
        np.testing.assert_allclose(np.asarray(a["plan"]), np.asarray(b["plan"]), atol=1e-5, rtol=0)


def test_result_file_round_trips(results):
    got, want, path = results
    loaded = load_results(path)
    assert json.dumps(loaded, sort_keys=True) == json.dumps(got, sort_keys=True)
    agg, agg_jax = aggregate_results(loaded), jax_aggregate(want)
    for k in ("trials", "success", "success_rate", "object_success", "object_count"):
        assert agg[k] == agg_jax[k], k
    summary = synthetic_eval.summary(loaded)
    assert summary["trials"] == 2 and summary["collisions"] == sum(
        int(r["collision"]) for r in loaded["10"]["nearest_first"].values()
    )
