"""Named block layout: the ABI between user-named values and flat solver
vectors.

Port of grasptrajopt_tpu/opt/layout.py: an ordered dict of named
(rows, cols) blocks with COLUMN-MAJOR `vec` / `unvec` round-trips, so
solution dictionaries keep the naming scheme ({model}/{d*}q/x,
{model}/{d*}q/p, ...) and a flat vector means the same in both packages.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch


class BlockLayout:
    def __init__(self):
        self.shapes: "OrderedDict[str, Tuple[int, int]]" = OrderedDict()
        # per-block discreteness (integer-valued decision blocks)
        self.is_discrete: Dict[str, bool] = {}

    def add(self, name: str, rows: int, cols: int = 1, discrete: bool = False) -> None:
        if name in self.shapes:
            raise KeyError(f"block '{name}' already exists")
        self.shapes[name] = (int(rows), int(cols))
        self.is_discrete[name] = bool(discrete)

    def variable_is_discrete(self, name: str) -> None:
        """Mark an existing block as integer-valued."""
        if name not in self.shapes:
            raise KeyError(name)
        self.is_discrete[name] = True

    def has_discrete_variables(self) -> bool:
        return any(self.is_discrete.values())

    def discrete_mask(self) -> np.ndarray:
        """Flat (size,) bool mask over the vec() ordering: True where the
        coordinate belongs to a discrete block."""
        parts = [np.full(r * c, self.is_discrete.get(name, False)) for name, (r, c) in self.shapes.items()]
        if not parts:
            return np.zeros(0, dtype=bool)
        return np.concatenate(parts)

    def __contains__(self, name: str) -> bool:
        return name in self.shapes

    def __len__(self) -> int:
        return len(self.shapes)

    @property
    def size(self) -> int:
        return sum(r * c for r, c in self.shapes.values())

    def offset(self, name: str) -> int:
        off = 0
        for n, (r, c) in self.shapes.items():
            if n == name:
                return off
            off += r * c
        raise KeyError(name)

    def vec(self, values: Dict, dtype=torch.float32, device="cuda") -> torch.Tensor:
        """Flatten a dict of blocks (tensors or arrays; column-major per
        block, insertion order) into one (size,) tensor on `device`;
        missing blocks are zero."""
        parts = []
        for name, (r, c) in self.shapes.items():
            if name in values:
                v = torch.as_tensor(values[name], dtype=dtype, device=device).reshape(r, c)
                parts.append(v.T.reshape(-1))  # column-major
            else:
                parts.append(torch.zeros(r * c, dtype=dtype, device=device))
        if not parts:
            return torch.zeros(0, dtype=dtype, device=device)
        return torch.cat(parts)

    def unvec(self, v) -> Dict[str, torch.Tensor]:
        """The (rows, cols) blocks of a flat (size,) tensor, as views."""
        out: Dict[str, torch.Tensor] = {}
        off = 0
        for name, (r, c) in self.shapes.items():
            out[name] = v[off : off + r * c].reshape(c, r).T  # column-major
            off += r * c
        return out

    def zeros_dict(self, dtype=torch.float32, device="cuda") -> Dict[str, torch.Tensor]:
        return {n: torch.zeros((r, c), dtype=dtype, device=device) for n, (r, c) in self.shapes.items()}
