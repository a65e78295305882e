"""Tracing, profiling and debugging helpers.

Port of grasptrajopt_tpu/utils/profiling.py:

  - PhaseTimer: named wall-clock phases; with `sync=True` each phase
    starts and ends with `torch.cuda.synchronize()` on the timer's device,
    so a phase's time includes the device work it enqueued. (The JAX
    timer's `jax.effects_barrier()` waits for effects, not for dispatched
    computations, so its phases may end before the device does.) Exports
    the result schema's `<phase>_time` keys.
  - trace(): `torch.profiler` over the block (CPU activity, and CUDA
    activity where a device is present), written in TensorBoard's format
    by `tensorboard_trace_handler`.
  - debug_guard(): inside it, any operation whose floating-point output
    holds a NaN raises FloatingPointError (the JAX package's
    `jax_debug_nans`). For debugging only: it checks every operation's
    output on the host.
  - device_memory_stats(): `torch.cuda.memory_stats` on the card.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def _cuda_or_none(device) -> Optional[torch.device]:
    """The CUDA device to synchronize or query: `device` if it is a CUDA
    device, the current one where `device` is None and a card is present,
    else None (the CPU: nothing to wait for)."""
    if device is None:
        return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else None
    device = torch.device(device)
    return device if device.type == "cuda" else None


class PhaseTimer:
    """Accumulates wall-clock time per named phase.

    with timer.phase("ik"): ...       # accumulates into 'ik'
    timer.means() -> {'ik_time': ...} # result-schema-compatible keys

    `device`: the CUDA device `sync=True` waits for (None: the current
    one where a card is present); on the CPU `sync` waits for nothing.
    """

    def __init__(self, sync: bool = True, device=None):
        self.sync = sync
        self._sync_device = _cuda_or_none(device) if sync else None
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def _wait(self):
        if self._sync_device is not None:
            torch.cuda.synchronize(self._sync_device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._wait()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._wait()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def means(self) -> Dict[str, float]:
        return {
            f"{k}_time": self.totals[k] / self.counts[k] for k in self.totals
        }

    def report(self) -> str:
        lines = [
            f"{k}: total {self.totals[k]:.3f}s over {self.counts[k]} calls "
            f"(mean {self.totals[k]/self.counts[k]:.3f}s)"
            for k in sorted(self.totals)
        ]
        return "\n".join(lines)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"totals": dict(self.totals), "counts": dict(self.counts)}, f)


@contextlib.contextmanager
def trace(logdir: str):
    """Profiler trace of the block (open with TensorBoard's profiler
    plugin, or chrome://tracing); yields the `torch.profiler.profile`."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for item in out:
            yield from _tensors(item)


class _NaNCheck(TorchDispatchMode):
    """Raises FloatingPointError on any operation whose floating-point
    output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if t.is_floating_point() and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def debug_guard(nans: bool = True, disable_jit: bool = False):
    """NaN checking for debugging solver divergence. `disable_jit` is
    accepted for the JAX package's signature and has no effect: eager
    PyTorch compiles nothing. The previous state comes back on exit."""
    with _NaNCheck() if nans else contextlib.nullcontext():
        yield


def device_memory_stats(device=None) -> Optional[dict]:
    """`torch.cuda.memory_stats` of the card (`device`, or the current
    one); None on the CPU."""
    dev = _cuda_or_none(device)
    return None if dev is None else torch.cuda.memory_stats(dev)
