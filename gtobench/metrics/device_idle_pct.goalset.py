"""The device's idle share of the traced window (goal-set cells)."""

from gtobench.layers import idle_pct


def read(run):
    return idle_pct(run)
