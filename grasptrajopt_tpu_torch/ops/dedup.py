"""Device-side voxel deduplication of point clouds, static shapes.

Port of grasptrajopt_tpu/ops/dedup.py, batch-first, kept for parity with
the JAX package bit for bit: one point per voxel cell survives, chosen by
a STABLE sort of a multiplicative hash of the cell id (first occurrence in
input order wins among equal hashes), then a stable partition of the
survivors to the front, truncated to `capacity`. Hashing makes any
capacity overflow drop cells pseudo-randomly instead of a contiguous
region. Known behavior carried over unchanged: distinct cells whose 31-bit
hashes collide merge, and a valid cell whose hash equals the 0x7FFFFFFF
sentinel is dropped.
"""

from __future__ import annotations

import numpy as np
import torch

# Fibonacci hashing constant 0x9E3779B1 as a signed int32; the int32
# product wraps modulo 2^32 exactly as in the JAX package
_HASH_MULT = int(np.int32(np.uint32(0x9E3779B1)))
_SENTINEL = 0x7FFFFFFF


def voxel_dedup(points, valid, voxel: float, capacity: int):
    """One point per `voxel` cell, compacted to `capacity` rows per cloud.

    points: (B, N, 3); valid: (B, N) bool. Returns (pts (B, C, 3),
    mask (B, C) bool, n_unique (B,)) with C = min(capacity, N); mask False
    rows are padding. Invalid points never survive.
    """
    inf = torch.full_like(points, float("inf"))
    lo = torch.amin(torch.where(valid[..., None], points, inf), dim=-2, keepdim=True)
    # 10 bits per axis (int32 id budget): cells beyond 1023 clip and merge
    cell = torch.floor((points - lo) / voxel).to(torch.int32)
    cell = torch.clamp(cell, 0, 1023)
    cid = (cell[..., 0] << 20) | (cell[..., 1] << 10) | cell[..., 2]
    h = (cid * torch.tensor(_HASH_MULT, dtype=torch.int32, device=cid.device)) & _SENTINEL
    h = torch.where(valid, h, torch.full_like(h, _SENTINEL))  # invalid sort last
    hs, order = torch.sort(h, dim=-1, stable=True)
    first = torch.cat(
        [torch.ones_like(hs[..., :1], dtype=torch.bool), hs[..., 1:] != hs[..., :-1]], dim=-1
    ) & (hs != _SENTINEL)
    n_unique = first.sum(dim=-1)
    # stable partition: kept points to the front, then truncate
    pos = torch.argsort((~first).to(torch.uint8), dim=-1, stable=True)[..., :capacity]
    idx = torch.gather(order, -1, pos)
    pts = torch.gather(points, -2, idx[..., None].expand(idx.shape + (3,)))
    return pts, torch.gather(first, -1, pos), n_unique
