"""Worker for the port's multi-process torch.distributed test
(test_torch_parallel.py); imports no JAX.

Launched as N OS processes; each joins the gloo process group through the
port's `parallel.distributed_init` (explicit coordinator, world size and
rank) and, on the data mesh over the ranks:
  1. `sharded_metric_reduce` of a sharded arange (the global mean);
  2. the box-LM solve of the JAX two-process test's problem through
     `make_sharded_solver` (the port's batch-first `make_box_lm_solver`),
     each rank's solutions against its targets;
  3. `shard_batch` of a batch that does not divide over the mesh (must
     raise);
  4. the bench's sharded stacked-field solve (`bench.ShardedSolveBench`:
     synth7 at a few points a link, float64) against the unsharded
     `solve_batch_stacked` of the same problems and tables, its mean cost
     against theirs.
Results land in a per-rank JSON the test reads.

Usage: python torch_distributed_worker.py <rank> <world> <coordinator> <out.json>
"""

import json
import sys


def main():
    rank, world, coordinator, out_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]

    import numpy as np
    import torch
    import torch.distributed as dist

    from grasptrajopt_tpu_torch import bench as pb
    from grasptrajopt_tpu_torch.opt.lm import LMConfig, make_box_lm_solver
    from grasptrajopt_tpu_torch.parallel import (
        data_mesh,
        distributed_init,
        make_sharded_solver,
        shard_batch,
        sharded_metric_reduce,
    )
    from grasptrajopt_tpu_torch.testing import make_synthetic_gto_robot

    torch.set_num_threads(1)
    initialized = distributed_init(coordinator, num_processes=world, process_id=rank, device="cpu")
    mesh = data_mesh(world)
    result = {"initialized": initialized, "rank": dist.get_rank(), "world": dist.get_world_size(),
              "backend": dist.get_backend()}

    # 1. the global mean of a sharded arange
    B = 2 * world
    host_vals = np.arange(B, dtype=np.float32)
    mean = sharded_metric_reduce(shard_batch(torch.as_tensor(host_vals), mesh), mesh)
    result["mean"], result["mean_expected"] = float(mean), float(host_vals.mean())

    # 2. the JAX worker's box-LM problem: x - target over a +-5 box, 10 iterations
    inner = make_box_lm_solver(lambda x, p: x - p, LMConfig(iterations=10))
    lo, hi = -5 * torch.ones(3), 5 * torch.ones(3)

    def solve_batch(targets):
        return inner(torch.zeros(targets.shape[0], 3), lo, hi, targets)

    host_targets = np.random.default_rng(0).normal(size=(B, 3)).astype(np.float32)
    local = shard_batch(torch.as_tensor(host_targets), mesh)
    (xs, cs, _), metrics = make_sharded_solver(solve_batch, mesh)(local)
    b = B // world
    result["solve_max_err"] = float(np.abs(xs.numpy() - host_targets[rank * b:(rank + 1) * b]).max())
    result["mean_cost"] = float(metrics["mean_cost"])
    costs = [torch.empty_like(cs) for _ in range(world)]
    dist.all_gather(costs, cs)
    result["mean_cost_of_gathered"] = float(torch.cat(costs).mean())

    # 3. a batch that does not divide over the mesh
    try:
        shard_batch(torch.zeros(2 * world + 1, 3), mesh)
        result["ragged_refused"] = False
    except ValueError:
        result["ragged_refused"] = True

    # 4. the bench's sharded stacked-field solve against the unsharded one
    robot = make_synthetic_gto_robot(device="cpu", dtype=torch.float64, points_per_link=3)
    cfg = pb.SolveBenchConfig(batch=2 * world, goal_capacity=2, T=12)
    bench = pb.ShardedSolveBench(robot, cfg, mesh)
    Q, cost, _ = bench.step()
    fields = bench.field.expand(cfg.batch, -1)
    Q_ref, cost_ref, _ = bench.solve_shard(bench.qc_opt, bench.X0, bench.params, fields, fields)
    b = cfg.batch // world
    result["stacked_q_max_err"] = float((Q - Q_ref[rank * b:(rank + 1) * b]).abs().max())
    result["stacked_shape"] = list(Q.shape)
    result["stacked_mean_cost"] = float(bench.metrics["mean_cost"])
    result["stacked_mean_cost_ref"] = float(cost_ref.mean())
    result["stacked_gates"] = bench.gates(Q)

    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main()
