"""Voxel-field lookups: floor-indexed, trilinear, and packed trilinear with
a closed-form gradient (kernel K4).

Port of grasptrajopt_tpu/ops/interp.py. The JAX package's
`packed_rows_gather` custom-vmap rule is a TPU batching workaround and is
not ported: here per-problem fields are one flat (B*2S, 8) table and each
problem adds its own row base to the offsets, so every lookup is a single
plain gather.

K4 (`field_lookup_packed_soa_grad`): the packed-row lookup that every
field-mode plan iteration runs, value and gradient in one pass. On the card
this is the hand-written CUDA kernel `csrc/field_lookup.cu`; its plain-torch
version `field_lookup_packed_soa_grad_reference` sits beside it. The
wrapper takes the plain version ONLY for tensors on the CPU; a CUDA tensor
launches the kernel or raises. The kernel never runs under `torch.func`
transforms: callers compute points (and their Jacobians) first and look
them up outside `vmap` / `jacfwd`.

Fields are flat (S,) arrays over a grid (origin, shape, resolution); grid
corner (i, j, k) sits at origin + (i, j, k) * resolution, row-major.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from grasptrajopt_tpu_torch.ops import cuda_build

# K4 launches in this process (`field_lookup_packed_soa_grad` on the card)
field_lookup_launches = 0


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


def _base_and_frac(points, origin, shape, resolution):
    """AoS points (..., 3): the clamped base cell (..., 3) long and the
    clamped fraction (..., 3) inside it."""
    u = (points - origin) / resolution
    hi = torch.tensor([shape[0] - 2, shape[1] - 2, shape[2] - 2], device=points.device)
    base = torch.minimum(torch.clamp(torch.floor(u).to(torch.long), min=0), hi)
    return base, torch.clamp(u - base.to(points.dtype), 0.0, 1.0)


def field_lookup_trilinear(field_flat, points, origin, shape, resolution):
    """Trilinear interpolation of a flat field at (..., 3) points from its
    8 corner values. Outside the grid the lookup clamps to the boundary
    cell."""
    base, frac = _base_and_frac(points, origin, shape, resolution)
    _, sy, sz = shape
    ix, iy, iz = base.unbind(-1)
    fx, fy, fz = frac.unbind(-1)

    def corner(dx, dy, dz):
        return field_flat[(iz + dz) + sz * ((iy + dy) + sy * (ix + dx))]

    c00 = corner(0, 0, 0) * (1 - fz) + corner(0, 0, 1) * fz
    c01 = corner(0, 1, 0) * (1 - fz) + corner(0, 1, 1) * fz
    c10 = corner(1, 0, 0) * (1 - fz) + corner(1, 0, 1) * fz
    c11 = corner(1, 1, 0) * (1 - fz) + corner(1, 1, 1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


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


def field_lookup_trilinear_packed(packed, points, origin, shape, resolution, row_offset=0):
    """Trilinear lookup of (..., 3) points against a `pack_corners` table:
    one row gather and a weight dot per point; `row_offset` selects the
    field slab of a stacked table."""
    base, frac = _base_and_frac(points, origin, shape, resolution)
    offs = base[..., 2] + shape[2] * (base[..., 1] + shape[1] * base[..., 0]) + row_offset
    rows = packed[offs]  # (..., 8)
    fx, fy, fz = frac.unbind(-1)
    wx = torch.stack([1 - fx, fx], dim=-1)
    wy = torch.stack([1 - fy, fy], dim=-1)
    wz = torch.stack([1 - fz, fz], dim=-1)
    w = (wx[..., :, None, None] * wy[..., None, :, None] * wz[..., None, None, :]).reshape(
        frac.shape[:-1] + (8,)
    )
    return torch.sum(rows * w, dim=-1)


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


def field_lookup_packed_soa_grad_reference(
    packed, x, y, z, origin, shape, resolution, row_offset=0
):
    """Plain-torch K4: packed trilinear lookup returning (value, d/dx,
    d/dy, d/dz) in closed form from one row gather per query. Outside the
    grid the clamped fraction saturates and that axis's gradient is zero."""
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


def _declare(lib):
    # every pointer and the stream as c_void_p: ctypes would cut a plain
    # int argument to 32 bits
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.gto_field_lookup.argtypes = [
        p, p, p, ll, i, p, i, p, ll, f, f, f, f, i, i, i, p, p, p, p, p,
    ]
    lib.gto_field_lookup.restype = ctypes.c_int
    lib.gto_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gto_cuda_error_string.restype = ctypes.c_char_p


def _uniform_stride(t) -> int:
    """The element stride s such that point i of `t` (flattened in
    row-major order) sits at data_ptr + s * i; raises if there is none."""
    s = None
    expect = None
    for size, st in reversed(list(zip(t.shape, t.stride()))):
        if size == 1:
            continue
        if s is None:
            s, expect = st, st * size
        elif st != expect:
            raise ValueError(f"K4 takes points with one stride between them, got strides {t.stride()}")
        else:
            expect = st * size
    return 1 if s is None else s


def _row_base(row_offset, shape, dev):
    """(row_base int32, rb_div): one row base per rb_div consecutive points."""
    n = int(np.prod(shape))
    if not isinstance(row_offset, torch.Tensor):
        return torch.full((1,), int(row_offset), dtype=torch.int32, device=dev), n
    if row_offset.device != dev or row_offset.dtype.is_floating_point or row_offset.dtype == torch.bool:
        raise ValueError(f"K4 takes an integer row_offset on {dev}, got {row_offset.dtype} on {row_offset.device}")
    if row_offset.dim() > len(shape):
        raise ValueError(f"row_offset {tuple(row_offset.shape)} does not broadcast to the points {tuple(shape)}")
    ro = row_offset.reshape((1,) * (len(shape) - row_offset.dim()) + tuple(row_offset.shape))
    if ro.numel() == 1:
        return ro.reshape(1).to(torch.int32), n
    if ro.shape[-1] == 1:  # one base per row of points
        return ro.expand(tuple(shape[:-1]) + (1,)).to(torch.int32).contiguous(), shape[-1]
    return ro.expand(tuple(shape)).to(torch.int32).contiguous(), 1


def field_lookup_packed_soa_grad(
    packed, x, y, z, origin, shape, resolution, row_offset=0
):
    """K4: (value, d/dx, d/dy, d/dz) of the packed trilinear field at the
    points (x, y, z), each of the points' shape; see
    `field_lookup_packed_soa_grad_reference`.

    `packed` (R, 8) is a `pack_corners` table (stacked fields one slab after
    the other); `row_offset` (int, or an integer tensor broadcastable to x)
    selects each point's slab. `origin` is a 3-sequence of floats or a
    tensor (host floats avoid a device read on the card).

    CPU tensors take the plain version. On the card, `packed` must be a
    contiguous float32 (R, 8) table and x / y / z float32 views with one
    common stride between consecutive points (SoA tensors, or the three
    coordinate views of a contiguous (..., 3) tensor); that launches
    `csrc/field_lookup.cu` once. Anything else raises.
    """
    global field_lookup_launches
    tensors = (packed, x, y, z)
    if all(t.device.type == "cpu" for t in tensors):
        return field_lookup_packed_soa_grad_reference(
            packed, x, y, z, origin, shape, resolution, row_offset
        )
    dev = x.device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"K4 needs its tensors on one CUDA device, got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"K4 takes float32, got {[t.dtype for t in tensors]}")
    if packed.dim() != 2 or packed.shape[1] != 8 or not packed.is_contiguous():
        raise ValueError(f"K4 takes a contiguous (R, 8) table, got {tuple(packed.shape)}")
    if packed.data_ptr() % 16:
        raise ValueError("K4 reads corner rows as 16-byte loads: the table must be 16-byte aligned")
    if x.shape != y.shape or x.shape != z.shape:
        raise ValueError(f"x, y, z shapes differ: {tuple(x.shape)}, {tuple(y.shape)}, {tuple(z.shape)}")
    stride = _uniform_stride(x)
    if _uniform_stride(y) != stride or _uniform_stride(z) != stride:
        raise ValueError("x, y and z must share one stride between points")
    n = x.numel()
    if n >= 2**31 or packed.shape[0] >= 2**31:
        raise ValueError(f"K4 indexes points and rows with int32: {n} points, {packed.shape[0]} rows")
    outs = tuple(torch.empty(x.shape, dtype=torch.float32, device=dev) for _ in range(4))
    if n == 0:
        return outs
    row_base, rb_div = _row_base(row_offset, tuple(x.shape), dev)
    if torch.is_tensor(origin):
        origin = origin.tolist()
    ox, oy, oz = (float(v) for v in origin)
    inv = float(np.float32(1.0 / resolution))
    lib = cuda_build.load("field_lookup", _declare)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gto_field_lookup(
            x.data_ptr(), y.data_ptr(), z.data_ptr(), stride, n, row_base.data_ptr(), rb_div,
            packed.data_ptr(), packed.shape[0], ox, oy, oz, inv,
            int(shape[0]), int(shape[1]), int(shape[2]),
            *(o.data_ptr() for o in outs), stream,
        )
    if err != 0:
        raise RuntimeError(f"K4 launch failed: {lib.gto_cuda_error_string(err).decode()}")
    field_lookup_launches += 1
    return outs
