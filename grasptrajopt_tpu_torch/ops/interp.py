"""Voxel-field lookups: floor-indexed and packed trilinear with a
closed-form gradient.

Port of grasptrajopt_tpu/ops/interp.py. The JAX package's
`packed_rows_gather` custom-vmap rule is a TPU batching workaround and is
not ported: here per-problem fields are one flat (B*2S, 8) table and each
problem adds its own row base to the offsets, so every lookup is a single
plain gather.

Fields are flat (S,) arrays over a grid (origin, shape, resolution); grid
corner (i, j, k) sits at origin + (i, j, k) * resolution, row-major.
"""

from __future__ import annotations

from typing import Tuple

import torch


def points_to_offsets(points, origin, shape: Tuple[int, int, int], resolution):
    """Flat row-major voxel offsets of (..., 3) points (floor + clamp)."""
    u = (points - origin) / resolution
    idx = torch.floor(u).to(torch.long)
    hi = torch.tensor([shape[0] - 1, shape[1] - 1, shape[2] - 1], device=points.device)
    idx = torch.minimum(torch.clamp(idx, min=0), hi)
    return idx[..., 2] + shape[2] * (idx[..., 1] + shape[1] * idx[..., 0])


def field_lookup_nearest(field_flat, points, origin, shape, resolution):
    """Field value at the floor-indexed cell of each point (zero gradient)."""
    return field_flat[points_to_offsets(points, origin, shape, resolution)]


def pack_corners(field_flat, shape: Tuple[int, int, int]):
    """The 8 trilinear corner values per cell: (..., S) -> (..., S, 8).

    Cells in the last slab along any axis replicate the boundary (the
    clamped base index of the unpacked lookup). Leading batch axes of
    `field_flat` are kept.
    """
    sx, sy, sz = shape
    f = field_flat.reshape(field_flat.shape[:-1] + (sx, sy, sz))
    dev = field_flat.device

    def shifted(dx, dy, dz):
        ix = torch.clamp(torch.arange(sx, device=dev) + dx, max=sx - 1)
        iy = torch.clamp(torch.arange(sy, device=dev) + dy, max=sy - 1)
        iz = torch.clamp(torch.arange(sz, device=dev) + dz, max=sz - 1)
        return f[..., ix[:, None, None], iy[None, :, None], iz[None, None, :]]

    corners = torch.stack(
        [
            shifted(0, 0, 0), shifted(0, 0, 1), shifted(0, 1, 0), shifted(0, 1, 1),
            shifted(1, 0, 0), shifted(1, 0, 1), shifted(1, 1, 0), shifted(1, 1, 1),
        ],
        dim=-1,
    )
    return corners.reshape(field_flat.shape[:-1] + (sx * sy * sz, 8))


def _cell_and_frac(x, y, z, origin, shape, resolution):
    inv = 1.0 / resolution
    ux = (x - origin[0]) * inv
    uy = (y - origin[1]) * inv
    uz = (z - origin[2]) * inv
    bx = torch.clamp(torch.floor(ux).to(torch.long), 0, shape[0] - 2)
    by = torch.clamp(torch.floor(uy).to(torch.long), 0, shape[1] - 2)
    bz = torch.clamp(torch.floor(uz).to(torch.long), 0, shape[2] - 2)
    offs = bz + shape[2] * (by + shape[1] * bx)
    return offs, ux - bx, uy - by, uz - bz, inv


def field_lookup_trilinear_packed_soa(
    packed, x, y, z, origin, shape, resolution, row_offset=0
):
    """Packed trilinear lookup with coordinates as three (..., P) tensors;
    `row_offset` (int or long tensor broadcastable to x) selects the field
    slab of a stacked table."""
    offs, rx, ry, rz, _ = _cell_and_frac(x, y, z, origin, shape, resolution)
    fx = torch.clamp(rx, 0.0, 1.0)
    fy = torch.clamp(ry, 0.0, 1.0)
    fz = torch.clamp(rz, 0.0, 1.0)
    rows = packed[offs + row_offset].to(x.dtype)  # (..., P, 8)
    w = torch.stack(
        [
            (1 - fx) * (1 - fy) * (1 - fz), (1 - fx) * (1 - fy) * fz,
            (1 - fx) * fy * (1 - fz), (1 - fx) * fy * fz,
            fx * (1 - fy) * (1 - fz), fx * (1 - fy) * fz,
            fx * fy * (1 - fz), fx * fy * fz,
        ],
        dim=-1,
    )
    return torch.sum(rows * w, dim=-1)


def field_lookup_packed_soa_grad(
    packed, x, y, z, origin, shape, resolution, row_offset=0
):
    """Packed trilinear lookup returning (value, d/dx, d/dy, d/dz) in closed
    form from one row gather per query. Outside the grid the clamped
    fraction saturates and that axis's gradient is zero."""
    offs, rx, ry, rz, inv = _cell_and_frac(x, y, z, origin, shape, resolution)
    fx = torch.clamp(rx, 0.0, 1.0)
    fy = torch.clamp(ry, 0.0, 1.0)
    fz = torch.clamp(rz, 0.0, 1.0)
    # clip derivative: 1 on [0, 1], 0 outside
    mx = ((rx >= 0.0) & (rx <= 1.0)).to(x.dtype) * inv
    my = ((ry >= 0.0) & (ry <= 1.0)).to(x.dtype) * inv
    mz = ((rz >= 0.0) & (rz <= 1.0)).to(x.dtype) * inv

    rows = packed[offs + row_offset].to(x.dtype)  # (..., P, 8)
    c000, c001, c010, c011, c100, c101, c110, c111 = rows.unbind(-1)
    c00 = c000 * (1 - fz) + c001 * fz
    c01 = c010 * (1 - fz) + c011 * fz
    c10 = c100 * (1 - fz) + c101 * fz
    c11 = c110 * (1 - fz) + c111 * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    val = c0 * (1 - fx) + c1 * fx
    gx = (c1 - c0) * mx
    gy = ((c01 - c00) * (1 - fx) + (c11 - c10) * fx) * my
    dz0 = (c001 - c000) * (1 - fy) + (c011 - c010) * fy
    dz1 = (c101 - c100) * (1 - fy) + (c111 - c110) * fy
    gz = (dz0 * (1 - fx) + dz1 * fx) * mz
    return val, gx, gy, gz
