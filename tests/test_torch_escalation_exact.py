"""GraspPipeline's exact escalation tier (`_plan_pergoal_exact`: the
per-goal re-solve in points mode on exact signed distances to the
observation's 2 cm scene point sets, obstacle weight 40, 12 iterations)
in the port against the JAX package's, on a two-view shelf observation
at 48x48 (tests/torch_parity.py: run_escalation_tier): the tier's plans
to 1e-6, its costs to 1e-6 relative, and the replay scorer's verdicts
(inside counts, collision, reach, reward) identical."""

import numpy as np

from torch_parity import run_escalation_tier


def test_exact_tier_matches_jax(monkeypatch):
    out = run_escalation_tier("exact", monkeypatch)
    got, want = out["port"], out["jax"]
    assert got["plans"].shape == want["plans"].shape and got["plans"].shape[2] == 12
    np.testing.assert_allclose(got["plans"], want["plans"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["costs"], want["costs"], atol=1e-6, rtol=1e-6)
    for g, w in zip(got["scores"], want["scores"]):
        for k in ("reached", "collision", "max_inside_points", "reward"):
            assert g[k] == w[k], k
    print(f"exact tier, both packages: {[s['collision'] for s in want['scores']]} collide, "
          f"{[s['reached'] for s in want['scores']]} reach, max inside "
          f"{[s['max_inside_points'] for s in want['scores']]}")
