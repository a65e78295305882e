"""Steady-state throughput driving: keep K solves in flight.

Port of grasptrajopt_tpu/parallel/streaming.py. PyTorch launches CUDA
work asynchronously: a call returns once its kernels are enqueued, not
when they have run. These two functions bound how many such calls are
outstanding and hand results back in submission order:

  - `stream_map(fn, inputs, inflight=K)`: run a solve over a sequence of
    input batches with at most K calls outstanding, yielding results in
    submission order.
  - `PlanStream`: the submit / collect interface for serving-style
    microbatching.

A call is retired by a `torch.cuda.Event` recorded on the current stream
right after `fn(*args)` returns; retiring waits on it
(`Event.synchronize`), the counterpart of `jax.block_until_ready`. A
result that holds no CUDA tensor is finished when `fn` returns, and no
event is recorded for it. Results (tensors, or tuples, lists, dicts and
NamedTuples of them) come back unchanged; the depth bound is what bounds
the live results, and nothing else is kept.

How much a depth above 1 can hide depends on where the solve waits: a
host-bound solve (the host issuing launches slower than the card runs
them) keeps the card idle whatever the depth, and a solve that reads a
device value on the host waits inside `fn` itself.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator, Optional

import torch

__all__ = ["stream_map", "PlanStream"]


def _cuda_device(result) -> Optional[torch.device]:
    """The device of the first CUDA tensor in `result` (a tensor, or
    tuples / lists / dicts of them), or None."""
    if isinstance(result, torch.Tensor):
        return result.device if result.is_cuda else None
    if isinstance(result, dict):
        result = result.values()
    elif not isinstance(result, (tuple, list)):
        return None
    for item in result:
        dev = _cuda_device(item)
        if dev is not None:
            return dev
    return None


def _launch(fn: Callable, args: tuple):
    """Call fn(*args) and record an event on the current stream of the
    result's device: (result, event or None)."""
    result = fn(*args)
    dev = _cuda_device(result)
    if dev is None:
        return result, None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    return result, event


def _retire(entry):
    result, event = entry
    if event is not None:
        event.synchronize()
    return result


def stream_map(
    fn: Callable,
    inputs: Iterable,
    inflight: int = 2,
) -> Iterator:
    """Map `fn` over input batches, keeping up to `inflight` calls
    outstanding; yields results in submission order.

    Each element of `inputs` is passed as `fn(*elem)` if it is a tuple,
    else `fn(elem)`. A result is yielded only once the device has finished
    the work enqueued by its call.

    inflight=1 is the synchronous loop.
    """
    if inflight < 1:
        raise ValueError(f"inflight must be >= 1, got {inflight}")
    pending: deque = deque()
    for elem in inputs:
        if len(pending) >= inflight:
            yield _retire(pending.popleft())
        pending.append(_launch(fn, elem if isinstance(elem, tuple) else (elem,)))
    while pending:
        yield _retire(pending.popleft())


class PlanStream:
    """Bounded-depth submit / collect pipeline around one solve.

    Usage:
        stream = PlanStream(solve, inflight=2)
        for batch in batches:
            for out in stream.submit(*batch):   # 0+ completed results
                consume(out)
        for out in stream.drain():
            consume(out)

    `submit` enqueues one call and returns any results whose completion
    the depth bound forced; `drain` flushes the rest. Results always come
    back in submission order.
    """

    def __init__(self, fn: Callable, inflight: int = 2):
        if inflight < 1:
            raise ValueError(f"inflight must be >= 1, got {inflight}")
        self._fn = fn
        self._inflight = inflight
        self._pending: deque = deque()
        self.submitted = 0
        self.completed = 0

    def submit(self, *args):
        """Enqueue fn(*args); return a list of results (possibly empty)
        that had to be retired to respect the depth bound."""
        done = []
        if len(self._pending) >= self._inflight:
            done.append(_retire(self._pending.popleft()))
            self.completed += 1
        self._pending.append(_launch(self._fn, args))
        self.submitted += 1
        return done

    def drain(self):
        """Retire every outstanding call, in order."""
        while self._pending:
            yield _retire(self._pending.popleft())
            self.completed += 1
