"""Sharded batch solving: each rank solves its shard, metrics are reduced.

Port of grasptrajopt_tpu/parallel/sharded.py. The JAX version vmaps a
per-problem solve and shard_maps it over the data axis; the port's
solvers are batch-first already, so each rank runs the caller's batch
solve on its local shard (from `mesh.shard_batch`) and the global mean
cost is one all_reduce of the local cost sum and count, on the device: no
value comes to the host.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _global_mean(values: torch.Tensor, mesh: DeviceMesh, axis_name: str) -> torch.Tensor:
    """Mean over every rank's (b,) values: one all_reduce(SUM) of the local
    (sum, count); the count is a fill, not a host copy."""
    count = torch.full((), values.shape[0], dtype=values.dtype, device=values.device)
    acc = torch.stack([torch.sum(values), count])
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=mesh.get_group(axis_name))
    return acc[0] / acc[1]


def make_sharded_solver(solve_batch: Callable, mesh: DeviceMesh, axis_name: str = "dp"):
    """Lift `solve_batch(*args) -> (Q, cost, ...)` to a sharded solver.

    Every argument is this rank's shard of a batch along its leading axis
    (`shard_batch`). Returns a function giving (the local outputs,
    {"mean_cost": the mean of out[1], the per-problem cost, over every
    rank's problems}), the metric a 0-dim tensor on the device."""

    def sharded(*args):
        out = solve_batch(*args)
        return out, {"mean_cost": _global_mean(out[1], mesh, axis_name)}

    return sharded


def sharded_metric_reduce(values, mesh: DeviceMesh, axis_name: str = "dp") -> torch.Tensor:
    """Global mean of a sharded (B,) metric: `values` is this rank's shard."""
    return _global_mean(values, mesh, axis_name)
