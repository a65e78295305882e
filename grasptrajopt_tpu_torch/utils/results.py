"""Result-JSON scoring (pure host logic, no simulator needed).

Copy of grasptrajopt_tpu/utils/results.py (host-only; any
import from the JAX package pulls in JAX).

The experiment drivers emit the reference's result schema:
  {scene_id: {ordering: {object: {reward, plan (ndof x 50), checking_time,
   ik_time, planning_time}}}}  (pybullet_gto_planning.py:323-338; mobile
runs add 'RT_base_new' per ordering, ..._mobile.py:247).

`aggregate_results` reproduces the success/time aggregation of
pybullet_evaluate_plans.py:248-269, so the committed IROS'24 JSONs re-score
to the BASELINE.md numbers — a regression oracle for the whole pipeline.
"""

from __future__ import annotations

import json
from typing import Dict


def load_results(path: str) -> dict:
    with open(path, "r") as f:
        return json.load(f)


def aggregate_results(results_scene: dict) -> Dict[str, float]:
    """Aggregate success + per-phase mean times over scene x ordering x object."""
    total_success = 0
    trials = 0
    object_success: Dict[str, int] = {}
    object_count: Dict[str, int] = {}
    sums = {"checking_time": 0.0, "ik_time": 0.0, "planning_time": 0.0}
    counts = {"checking_time": 0, "ik_time": 0, "planning_time": 0}

    for scene_id, orderings in results_scene.items():
        for ordering, objects in orderings.items():
            if ordering == "RT_base_new":
                continue
            for object_name, rec in objects.items():
                if not isinstance(rec, dict) or "reward" not in rec:
                    continue
                trials += 1
                r = int(rec["reward"])
                total_success += r
                object_success[object_name] = object_success.get(object_name, 0) + r
                object_count[object_name] = object_count.get(object_name, 0) + 1
                for key in sums:
                    t = rec.get(key)
                    if t is not None:
                        sums[key] += float(t)
                        counts[key] += 1

    out = {
        "trials": trials,
        "success": total_success,
        "success_rate": total_success / trials if trials else 0.0,
        "object_success": object_success,
        "object_count": object_count,
    }
    for key in sums:
        out[f"mean_{key}"] = sums[key] / counts[key] if counts[key] else None
    return out
