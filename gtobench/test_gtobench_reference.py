"""The reference against the program at a tiny size on the CPU, through a
whole run of the cell (the look for a card skipped): `correct` comes out
true; and with the timed path broken underneath, once for each fault the
cell can have, it comes out false. (The exchange between chips is no
fault of this one-chip cell.)"""

from __future__ import annotations

import json

import pytest
import torch

from gtobench import run
from gtobench.testcells import tiny  # noqa: F401  (a fixture)


def _result(capsys, workload: str, seed: int = 2**31 + 12345) -> dict:
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", "1", "--trace", "0"],
                  device=torch.device("cpu"))
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out)[-1] == "checks"
    return out


@pytest.mark.parametrize("seed", [2**31 + 12345, 7])
def test_the_program_agrees_with_the_reference(tiny, capsys, seed):
    out = _result(capsys, "goalset-b2048-stream", seed)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"setup_s", "plans_per_s"}
    assert list(out["checks"]) == ["plan_gap_rad", "cost_gap_rel", "warm_start_miss_share"]


def _unchanged_plans(monkeypatch):
    from grasptrajopt_tpu_torch import bench

    step = bench.SolveBench.step

    def broken(self):
        Q, cost, aux = step(self)
        return torch.cat([Q[:, :2], self.X0], 1), cost, aux

    monkeypatch.setattr(bench.SolveBench, "step", broken)


def _half_the_batch(monkeypatch):
    from grasptrajopt_tpu_torch import bench

    step = bench.SolveBench.step

    def broken(self):
        Q, cost, aux = step(self)
        h = Q.shape[0] // 2
        return torch.cat([Q[: Q.shape[0] - h], Q[:h]]), torch.cat([cost[: Q.shape[0] - h], cost[:h]]), aux

    monkeypatch.setattr(bench.SolveBench, "step", broken)


def _altered_plan(monkeypatch):
    from grasptrajopt_tpu_torch import bench

    step = bench.SolveBench.step

    def broken(self):
        Q, cost, aux = step(self)
        Q = Q.clone()
        Q[-1, -1, 3] += 0.5
        return Q, cost, aux

    monkeypatch.setattr(bench.SolveBench, "step", broken)


def _warm_start_at_the_start_pose(rows):
    def fault(monkeypatch):
        from grasptrajopt_tpu_torch import bench

        warm_start = bench.warm_start

        def broken(robot, ik, qc, tf_goal, T, *args, **kwargs):
            X0, goal = warm_start(robot, ik, qc, tf_goal, T, *args, **kwargs)
            X0 = X0.clone()
            X0[rows(X0.shape[0])] = robot.extract_optimized_dimensions(qc)
            return X0, goal

        monkeypatch.setattr(bench, "warm_start", broken)

    return fault


@pytest.mark.parametrize("fault", [
    _unchanged_plans, _half_the_batch, _altered_plan,
    _warm_start_at_the_start_pose(lambda B: slice(None)),
    _warm_start_at_the_start_pose(lambda B: slice(B - B // 2, None)),
], ids=["plans_unchanged", "half_the_batch", "altered_plan", "warm_start_unchanged", "warm_start_half"])
def test_a_broken_solve_is_not_correct(tiny, capsys, monkeypatch, fault):
    fault(monkeypatch)
    assert not _result(capsys, "goalset-b2048-stream")["correct"]
