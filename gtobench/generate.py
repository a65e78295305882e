"""The one generator of the benchmark's inputs, from a traffic file's
parameters and the run's seed.

Every seed gives the same sizes (problems a solve, goals a set) and the
same amount of work; the seed only moves the values: the goal sets'
poses. The same seed gives the same inputs.

A goal-set batch is a fixed set of anchor grasps, one a problem, each
goal of a set the anchor turned by a further step of yaw and moved by a
Gaussian jitter. The first perception (`goal_sets`) is what the warm
start is worked out from; every solve of the window (`GoalStream`) sees
the same anchors under a fresh jitter, drawn on the device from the seed
and the solve's index: a re-plan of every problem after a new perception
of its grasps, from the warm start of the first.
"""

from __future__ import annotations

import numpy as np
import torch


def rng(seed: int, stream: str) -> np.random.Generator:
    """A generator for one named input stream of a run: streams of one seed
    are independent, and any whole number is a seed."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), sum(stream.encode())])


def goal_anchors(traffic: dict, goals: int, seed: int) -> np.ndarray:
    """(batch, goals, 4, 4) float64 goal poses without jitter, in the
    robot's frame: per problem an anchor grasp (the hand pointing down at
    `height_m`, its position uniform in the x and y ranges) turned about
    the world z axis by a yaw uniform in +-`yaw_rad`; each goal of the set
    the anchor turned by a further `slot_yaw_rad` times its slot index."""
    r = rng(seed, "goal_sets")
    B, G = int(traffic["batch"]), int(goals)
    x = r.uniform(*traffic["x_m"], size=B)
    y = r.uniform(*traffic["y_m"], size=B)
    yaw = r.uniform(-traffic["yaw_rad"], traffic["yaw_rad"], size=B)
    down = np.diag([1.0, -1.0, -1.0])  # the hand's z axis pointing down
    out = np.tile(np.eye(4), (B, G, 1, 1))
    a = yaw[:, None] + traffic["slot_yaw_rad"] * np.arange(G)[None, :]
    c, s = np.cos(a), np.sin(a)
    Rz = np.zeros((B, G, 3, 3))
    Rz[..., 0, 0], Rz[..., 0, 1], Rz[..., 1, 0], Rz[..., 1, 1], Rz[..., 2, 2] = c, -s, s, c, 1.0
    out[..., :3, :3] = Rz @ down
    out[..., 0, 3] = x[:, None]
    out[..., 1, 3] = y[:, None]
    out[..., 2, 3] = traffic["height_m"]
    return out


def goal_sets(traffic: dict, goals: int, seed: int) -> np.ndarray:
    """(batch, goals, 4, 4) float32: the first perception, the anchors with
    Gaussian jitter of `jitter_m` a coordinate."""
    out = goal_anchors(traffic, goals, seed)
    B, G = out.shape[:2]
    out[..., :3, 3] += rng(seed, "jitter").normal(scale=traffic["jitter_m"], size=(B, G, 3))
    return out.astype(np.float32)


class GoalStream:
    """The goal sets of the window's solves on `device`: solve k's are the
    anchors with a fresh jitter drawn by a generator on the device, seeded
    from (seed, k), so that `goals(k)` gives the same tensor again after
    the window."""

    def __init__(self, traffic: dict, goals: int, seed: int, device, dtype=torch.float32):
        self.anchors = torch.as_tensor(goal_anchors(traffic, goals, seed), dtype=dtype, device=device)
        self.jitter = float(traffic["jitter_m"])
        self.seed = int(seed)
        self.generator = torch.Generator(device=device)

    def goals(self, k: int) -> torch.Tensor:
        state = np.random.SeedSequence([abs(self.seed), int(self.seed < 0), int(k)]).generate_state(2)
        self.generator.manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)
        a = self.anchors
        jitter = torch.randn(a.shape[:-2] + (3,), generator=self.generator, device=a.device, dtype=a.dtype)
        pos = a[..., :3, 3] + self.jitter * jitter
        return torch.cat([torch.cat([a[..., :3, :3], pos[..., None]], -1), a[..., 3:, :]], -2)
