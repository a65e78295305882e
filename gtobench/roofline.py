"""Peaks of the card and the least time a kernel's work could take.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): 3.35 TB/s of HBM and 67 TFLOP/s of
float32 outside the tensor cores, which is 3.35e13 fused multiply-adds a
second, the rate of FP32 lane instructions (each FMA one instruction) that
a kernel's operations are counted in.

A kernel's bound counts each input byte read once and each output byte
written once, and its operations from the shapes of the call, never from
what the kernel reads again through its caches. A share of the bound is
bound over measured time, so it cannot pass 100% unless the bytes or
operations are counted too high.
"""

from __future__ import annotations

from typing import Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 3.35e13


def bound_s(nbytes: float, instructions: float = 0.0) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time of work that
    moves `nbytes` and issues `instructions` FP32 lane instructions."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, instructions / FP32_INSTR_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k4_bytes(points: int, table_rows: int, row_bases: int) -> int:
    """Bytes of one K4 launch (`field_lookup_packed_soa_grad`): each
    point's x, y, z read once (float32), its value and three gradient
    components written once (float32), the int32 row bases read once, and
    the float32 (R, 8) corner table read once. (The JAX bench's
    `gather_bytes` counts a 32-byte corner row for every point instead:
    rows that neighbouring points share come from the cache, so that count
    can pass the card's bandwidth.)"""
    return 4 * (3 * points + 4 * points + row_bases + 8 * table_rows)


def k4_bound_s(launches: Sequence[Tuple[int, int, int]]) -> float:
    """Summed bound of K4 launches, each (points, table_rows, row_bases)."""
    return sum(bound_s(k4_bytes(*launch))[0] for launch in launches)


def share_pct(bound: float, measured: float):
    """100 x bound / measured, or None where nothing was measured."""
    if measured <= 0.0:
        return None
    return 100.0 * bound / measured
