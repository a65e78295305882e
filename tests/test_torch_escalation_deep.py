"""GraspPipeline's deep escalation tier (`_plan_pergoal_deep`: the
per-goal field re-solve at 12 iterations, a 4x goal weight, no coarse
phase and no final_trust) in the port against the JAX package's, on a
two-view shelf observation at 48x48 with each package's own cost fields
(tests/torch_parity.py: run_escalation_tier): the tier's plans to 1e-6,
its costs to 1e-6 relative, and the replay scorer's verdicts (inside
counts, collision, reach, reward) identical."""

import numpy as np

from torch_parity import run_escalation_tier


def test_deep_tier_matches_jax(monkeypatch):
    out = run_escalation_tier("deep", monkeypatch)
    got, want = out["port"], out["jax"]
    assert got["plans"].shape == want["plans"].shape and got["plans"].shape[2] == 12
    np.testing.assert_allclose(got["plans"], want["plans"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["costs"], want["costs"], atol=1e-6, rtol=1e-6)
    for g, w in zip(got["scores"], want["scores"]):
        for k in ("reached", "collision", "max_inside_points", "reward"):
            assert g[k] == w[k], k
    print(f"deep tier, both packages: {[s['collision'] for s in want['scores']]} collide, "
          f"{[s['reached'] for s in want['scores']]} reach, max inside "
          f"{[s['max_inside_points'] for s in want['scores']]}")
