"""Run one cell of the benchmark once, from the root of a checkout:

    python3 -m gtobench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is the entry of `BENCHMARK.json`'s `workloads` named by
`--workload`; its configuration names the driver (`gtobench/drivers/`)
that sets the program up from the seed, runs the measured window and
checks what the window produced against the plain reference.

A run: set-up (the program's objects, the inputs drawn from the seed, one
warm-up call of the cell's shapes) timed as `setup_s`; the window of
`--seconds`, whole calls back to back, traced by `torch.profiler` with
`--trace 1`; the device's peak memory; the check that nothing of JAX or
the JAX package was loaded; the program's state freed; the comparison
with the reference. It prints the parts of the set-up and every number
compared beside its limit as the last lines of standard error, and as the
last line of standard output one JSON object: `correct`, `attempted` and
`failed` (units of work: plans), `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer metrics), `device`, with
`--trace 1` `breakdown`, and `checks` last.

It exits with another code than 0, printing no result, when the card (or
as many cards as the cell asks for) is missing, when the manifest or a
file it names is missing, and when a JAX module was loaded.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

ROOT = Path.cwd()
CACHE = ROOT / ".gtobench_cache"  # fixed directories inside the checkout


def _environment() -> None:
    """Compiler caches inside the checkout at fixed paths, one thread for
    host-side math, and no JAX behind any library; set before torch is
    imported."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


@dataclass
class Run:
    """What a metric's reader reads: the set-up time, the window's calls
    (host clock), the trace of the window (with --trace 1) and the
    driver's record of the work a call launches."""

    workload: str
    units: str  # "plans"
    setup_s: float
    window: object  # gtobench.window.Window
    trace: Optional[object]  # gtobench.trace.TraceSummary
    layer: dict


def _fail(message: str, code: int) -> int:
    print(f"gtobench: {message}", file=sys.stderr)
    return code


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, device=None) -> int:
    """Run the cell; `device` (tests only) skips the look for a card and
    runs on the device given."""
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from gtobench import guard, manifest

    try:
        cell = manifest.cell(manifest.load(ROOT), ROOT, args.workload)
    except (OSError, KeyError, ValueError) as e:
        return _fail(f"cannot read the cell: {e!r}", 2)

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            return _fail(f"the cell needs {cell.chips} CUDA device(s); {n} available", 3)
        device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        drivers = importlib.import_module(f"gtobench.drivers.{cell.config['driver']}")
    except ModuleNotFoundError as e:
        return _fail(f"the driver is missing: {e!r}", 2)

    t0 = time.perf_counter()
    try:
        driver = drivers.Driver(cell, args.seed, device)
    except ModuleNotFoundError as e:  # a checkout without the program
        return _fail(f"the program is missing: {e!r}", 2)
    _sync(device)
    setup_s = time.perf_counter() - t0

    summary = None
    if args.trace:
        from gtobench.trace import Tracer

        with Tracer(device) as tracer:
            window = driver.window(args.seconds)
        summary = tracer.summary(window.spans() + driver.host_spans(window), window.end, window.start)
    else:
        window = driver.window(args.seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    bad = guard.forbidden_modules()
    if bad:
        return _fail(f"JAX modules were loaded: {bad}", 4)

    run = Run(args.workload, drivers.UNITS, setup_s, window, summary, driver.layer_record())
    metrics = manifest.read_metrics(cell.per_layer if args.trace else cell.end_to_end, run)
    driver.release()
    checks = [(name, v, cell.limits[name]) for name, v in driver.check()]
    bad = guard.forbidden_modules()
    if bad:
        return _fail(f"JAX modules were loaded: {bad}", 4)

    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": correct, "attempted": window.units, "failed": 0 if correct else window.units,
              "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    print(f"window: {len(window.calls)} calls, {window.units} {drivers.UNITS}, "
          f"{window.end - window.start:.3f} s to the last completion; each call's issue to done (s): "
          f"{[round(c.done - c.issued, 4) for c in window.calls]}; the process's CPU seconds in each: "
          f"{[round(c.cpu, 4) for c in window.calls]}", file=sys.stderr)
    print(f"setup_s parts (s): {driver.setup_phases}", file=sys.stderr)
    for name, v, lim in checks:
        print(f"check {name}: {v!r} (limit {lim!r}) {'ok' if math.isfinite(v) and v <= lim else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
