"""Scale-out and serving on torch.distributed and CUDA streams.

Independent (scene x grasp-set x seed) problems are a batch axis sharded
over the ranks of a data mesh (`data_mesh`, `shard_batch`); each rank
solves its shard and metrics are reduced with an all_reduce
(`make_sharded_solver`, `sharded_metric_reduce`); `distributed_init`
joins the processes (NCCL on CUDA devices, gloo on the CPU). On one card,
`stream_map` and `PlanStream` keep a bounded number of batched solves in
flight and retire them in submission order.
"""

from grasptrajopt_tpu_torch.parallel.mesh import data_mesh, distributed_init, shard_batch
from grasptrajopt_tpu_torch.parallel.sharded import make_sharded_solver, sharded_metric_reduce
from grasptrajopt_tpu_torch.parallel.streaming import PlanStream, stream_map

__all__ = [
    "data_mesh",
    "distributed_init",
    "shard_batch",
    "make_sharded_solver",
    "sharded_metric_reduce",
    "PlanStream",
    "stream_map",
]
