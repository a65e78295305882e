"""Serving-style pipelining of batched solves on one card: `stream_map`
and `PlanStream` keep a bounded number of solves in flight and retire
them in submission order."""

from grasptrajopt_tpu_torch.parallel.streaming import PlanStream, stream_map

__all__ = ["PlanStream", "stream_map"]
