"""Constants built on the device without a copy from host memory.

`torch.tensor(values, device=cuda)` copies from pageable host memory,
and that copy synchronizes: the host waits until the card has drained
its stream, so it can no longer enqueue work ahead of the card. A solve
therefore builds its constants by fills (each value a kernel argument)
or once, where its solver is constructed.
"""

from __future__ import annotations

from typing import Sequence

import torch


def device_vector(values: Sequence[float], dtype, device) -> torch.Tensor:
    """The 1-D tensor of `values` (Python numbers) on `device`, one fill a
    value; each value rounds to `dtype` as `torch.tensor` rounds it."""
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out
