"""Synchronizing CUDA calls inside the program's solves (its `solve` spans
count them under `torch.cuda.set_sync_debug_mode`) over the traced
window's solves."""

from gtobench.spans import syncs_per_call


def read(run):
    return syncs_per_call(run)
