"""Exact-fp32 brute-force nearest neighbours: kernels K1, K2 and K3.

Port of grasptrajopt_tpu/ops/nn.py.

K1 (`min_d2_batched`, `_pack_ref4`, `min_sqdist_d2`): the dense SDF field
build asks, for each of M query points, the squared distance to the
nearest valid point of each of B reference clouds. On the card this is
the hand-written CUDA kernel `csrc/min_d2.cu`, which splits the cloud
over a thread-block cluster where the queries alone would not fill the
card (`_k1_launch_plan`).

K2 and K3 (`nearest_batched`, one kernel `csrc/nearest.cu` in two modes):
per query, the squared distance to the nearest valid reference point AND
its index; K2 also returns that point and its normal (points mode's signed
distance, `signed_distance_with_dir`), K3 (`min_sqdist`) only the pair
(d2, index) under a validity mask. It reads K1's (C, N, 4) rows and splits
the cloud the same way (`_k2_launch_plan`).

Each kernel has its plain-torch version beside it (`*_reference`). The
wrappers take the plain version ONLY for tensors on the CPU; a CUDA
tensor launches the kernel or raises.

Ties: the nearest point is the FIRST index among equally near points, in
kernel and plain version alike. The JAX package's TPU kernel K2 instead
averages the tied points and normals (its one-hot matmul), while its CPU
path takes the first argmin; the port follows the latter everywhere.

Distances are always the three broadcast subtract-squares in the working
precision, never the |q|^2 + |r|^2 - 2 q.r expansion, which cancels
catastrophically near the surface.

Callers are batch-first: one call covers every cloud of the batch, so each
field pass is ONE kernel launch.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from grasptrajopt_tpu_torch.ops import cuda_build

# penalty of an invalid reference point (the JAX package's _PAL_BIG)
PENALTY_BIG = 3.0e38

# kernel launches in this process: K1 (`min_d2_batched`), K2
# (`nearest_batched` with normals) and K3 (`nearest_batched` without)
min_d2_launches = 0
nearest_launches = 0
min_sqdist_launches = 0

_REFERENCE_CHUNK_ELEMS = 1 << 24  # (batch x queries x points) per plain chunk


def _pack_ref4(ref, ref_mask=None):
    """(B, N, 3) [+ (B, N) bool mask] -> (B, N, 4) rows x, y, z, penalty
    (0 valid, PENALTY_BIG invalid), the layout K1, K2 and K3 read: 16
    bytes a point, so any run of points is one contiguous, aligned span.
    No padding: the kernels mask the ragged edge themselves."""
    pen = torch.zeros(ref.shape[:-1] + (1,), dtype=ref.dtype, device=ref.device)
    if ref_mask is not None:
        pen = torch.where(ref_mask[..., None], pen, torch.full_like(pen, PENALTY_BIG))
    return torch.cat([ref, pen], dim=-1).contiguous()


def min_d2_batched_reference(q, r4):
    """Plain-torch K1: q (M, 3) shared or (B, M, 3) per cloud; r4 (B, N, 4).
    Returns (B, M) = max(0, min_n (|q - r_n|^2 + pen_n)).

    Chunked over M so the (B, M, N) distance tensor never materializes
    (at the field build's widths it would be 4.7 GB per cloud).
    """
    B, N, _ = r4.shape
    qb = q if q.dim() == 3 else q[None]
    M = qb.shape[1]
    rx, ry, rz, pen = (r4[:, None, :, i] for i in range(4))  # (B, 1, N)
    out = torch.empty((B, M), dtype=r4.dtype, device=r4.device)
    chunk = max(1, _REFERENCE_CHUNK_ELEMS // max(B * N, 1))
    for m0 in range(0, M, chunk):
        qc = qb[:, m0 : m0 + chunk]
        acc = (qc[..., 0:1] - rx) ** 2
        acc = acc + (qc[..., 1:2] - ry) ** 2
        acc = acc + (qc[..., 2:3] - rz) ** 2
        acc = acc + pen
        out[:, m0 : m0 + chunk] = torch.amin(acc, dim=-1)
    return torch.clamp(out, min=0.0)


@dataclass(frozen=True)
class _Geometry:
    """A cluster-split kernel's launch constants: a block takes tile_m =
    threads x qpt queries; a cluster of S blocks splits each cloud into S
    contiguous shares, equal to a point."""

    name: str
    tile_m: int  # queries a block where the query tiles fill the card
    min_tile_m: int  # ... and at the least
    min_share: int  # points a share at the least where S > 1
    max_split: int  # the largest cluster the kernel takes
    waves: int  # the grid should cover the card this many times over


# K1's launch geometry (csrc/min_d2.cu): 256-query blocks, down to 128
# where the grid is short; its shares stream in K1_TILE_N-point tiles.
K1_QPT = 2
K1_TILE_M = 256  # 128 threads
K1_MIN_TILE_M = 128  # 64 threads
K1_TILE_N = 512
K1_MAX_SPLIT = 8  # the portable cluster size
K1_WAVES = 2
# resident 256-query blocks an SM holds by nvcc's report (32 registers,
# 26,648 bytes of shared memory: 8 of the SM's 227 KB); on the card the
# wrapper asks the occupancy API instead
K1_BLOCKS_PER_SM = 8
K1 = _Geometry("K1", K1_TILE_M, K1_MIN_TILE_M, K1_TILE_N, K1_MAX_SPLIT, K1_WAVES)

# K2 / K3's (csrc/nearest.cu): 512-query blocks (128 threads x 4), down
# to 128; each share streams through a ring of 2 buffers of K2_CHUNK
# points (a share of at most 2 chunks stays resident);
# S up to 16, the non-portable cluster size, where the card admits it
# (`_k2_card`), and shares of at least 256 points.
K2_QPT = 4
K2_TILE_M = 512
K2_MIN_TILE_M = 128
K2_CHUNK = 512
K2_SUB = 32  # points a sub-tile of the kernel's argmin record
K2_MAX_SPLIT = 16
K2_WAVES = 2
# resident 512-query blocks an SM holds by nvcc's report (50 registers:
# 9 blocks of 128 threads); on the card the wrapper asks the occupancy
# API instead
K2_BLOCKS_PER_SM = 9
K2 = _Geometry("K2/K3", K2_TILE_M, K2_MIN_TILE_M, 256, K2_MAX_SPLIT, K2_WAVES)


def _cluster_plan(g, B, M, N, sm_count, blocks_per_sm, max_split=None, split=None):
    """(tile_m, S) for one launch of kernel geometry `g` over B clouds of N
    points against M queries each, on a card of `sm_count` SMs that holds
    `blocks_per_sm` of its blocks each and admits clusters of up to
    `max_split` (default: g.max_split) blocks.

    The grid is S x B x ceil(M / tile_m) blocks; the plan aims for
    g.waves x sm_count x blocks_per_sm of them. It takes the smallest S (a
    power of two, at most max_split and at most one share per g.min_share
    points) that reaches the aim with g.tile_m-query tiles, so S = 1 where
    the queries alone fill the card; where S at its largest still leaves
    the grid short, it halves the query tile, down to g.min_tile_m.
    `split` forces S at g.tile_m (tests, measurements)."""
    if split is not None:
        if split < 1 or split > g.max_split or split & (split - 1):
            raise ValueError(f"{g.name}'s split must be a power of two up to {g.max_split}, got {split}")
        return g.tile_m, split
    max_split = g.max_split if max_split is None else min(max_split, g.max_split)
    target = g.waves * sm_count * blocks_per_sm
    top = 1
    while top * 2 <= min(max_split, N // g.min_share):
        top *= 2
    tile_m = g.tile_m
    while True:
        blocks = B * -(-M // tile_m)
        S = 1
        while S < top and blocks * S < target:
            S *= 2
        if blocks * S >= target or tile_m == g.min_tile_m:
            return tile_m, S
        tile_m //= 2


def _k1_launch_plan(B, M, N, sm_count, blocks_per_sm=K1_BLOCKS_PER_SM, split=None):
    """K1's (tile_m, S): `_cluster_plan` with K1's geometry, S at most 8."""
    return _cluster_plan(K1, B, M, N, sm_count, blocks_per_sm, split=split)


def _k2_launch_plan(C, M, N, sm_count, blocks_per_sm=K2_BLOCKS_PER_SM, max_split=K2_MAX_SPLIT, split=None):
    """K2 / K3's (tile_m, S): `_cluster_plan` with their geometry, S at
    most `max_split` (16 where the card admits it, else 8)."""
    return _cluster_plan(K2, C, M, N, sm_count, blocks_per_sm, max_split, split)


def _shares(N, S):
    """[(n0, n1)]: the points each of the S blocks of a cluster walks, as
    csrc/min_d2.cu and csrc/nearest.cu cut them."""
    return [(N * s // S, N * (s + 1) // S) for s in range(S)]


_k1_cards = {}
_k2_cards = {}


def _k1_card(dev):
    """(SMs, resident K1 blocks an SM holds) of CUDA device `dev`."""
    if dev.index not in _k1_cards:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _k1_cards[dev.index] = (sms, min_d2_occupancy(dev, K1_TILE_M, 1)[0])
    return _k1_cards[dev.index]


def _k2_card(dev):
    """(SMs, resident K2 / K3 blocks an SM holds, the largest cluster it
    admits: 16 or 8) of CUDA device `dev`. The blocks are counted without
    a share in shared memory, the plan's fill target where shares are
    small; 16 counts where a cluster of 16 small-share blocks can be
    resident."""
    if dev.index not in _k2_cards:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        blocks = nearest_occupancy(dev, 1, K2_TILE_M, 1)[0]
        try:
            wide = nearest_occupancy(dev, K2_MAX_SPLIT * K2_CHUNK, K2_MIN_TILE_M, K2_MAX_SPLIT)[1] >= 1
        except RuntimeError:  # the runtime refuses the cluster size itself
            wide = False
        _k2_cards[dev.index] = (sms, blocks, K2_MAX_SPLIT if wide else 8)
    return _k2_cards[dev.index]


def _declare(lib):
    # every pointer and the stream as c_void_p: ctypes would cut a plain
    # int argument to 32 bits
    lib.gto_min_d2.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.gto_min_d2.restype = ctypes.c_int
    lib.gto_min_d2_occupancy.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.gto_min_d2_occupancy.restype = ctypes.c_int
    lib.gto_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gto_cuda_error_string.restype = ctypes.c_char_p


def _declare_nearest(lib):
    lib.gto_nearest.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.gto_nearest.restype = ctypes.c_int
    lib.gto_nearest_occupancy.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.gto_nearest_occupancy.restype = ctypes.c_int
    lib.gto_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gto_cuda_error_string.restype = ctypes.c_char_p


def _check_cuda(name, *tensors):
    """A CUDA launch takes contiguous float32 tensors on one device."""
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{name} needs its tensors on one CUDA device, got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name} takes float32, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")


def _check_shapes(name, q, r4):
    """K1-K3 take (B, N, 4) rows and (M, 3) or (B, M, 3) queries."""
    if r4.dim() != 3 or r4.shape[2] != 4:
        raise ValueError(f"{name}: r4 must be (B, N, 4), got {tuple(r4.shape)}")
    if q.dim() not in (2, 3) or q.shape[-1] != 3:
        raise ValueError(f"{name}: q must be (M, 3) or (B, M, 3), got {tuple(q.shape)}")
    if q.dim() == 3 and q.shape[0] != r4.shape[0]:
        raise ValueError(f"{name}: per-cloud queries {tuple(q.shape)} do not match r4 {tuple(r4.shape)}")
    if q.shape[-2] == 0 or r4.shape[1] == 0:
        raise ValueError(f"{name} needs at least one query and one reference point")


def min_d2_batched(q, r4, split=None):
    """K1: (B, M) min squared distances of q ((M, 3) shared or (B, M, 3))
    to the B reference sets of r4 ((B, N, 4), see `_pack_ref4`).

    CPU tensors take `min_d2_batched_reference`. CUDA tensors must be
    contiguous float32 on one device, r4 16-byte aligned, and launch the
    kernel once with `_k1_launch_plan`'s geometry; `split` forces the
    cluster size S (1, 2, 4 or 8); the output is the same bits for every
    S. Anything else, and a launch the card refuses, raises.
    """
    global min_d2_launches
    _check_shapes("K1", q, r4)
    B, N, _ = r4.shape
    M = q.shape[-2]
    if split is not None:
        _k1_launch_plan(B, M, N, 1, split=split)  # validates it
    if q.device.type == "cpu" and r4.device.type == "cpu":
        return min_d2_batched_reference(q, r4)
    _check_cuda("K1", q, r4)
    if r4.data_ptr() % 16:
        raise ValueError("K1 takes r4 at a 16-byte aligned address")
    tile_m, S = _k1_launch_plan(B, M, N, *_k1_card(q.device), split=split)
    out = torch.empty((B, M), dtype=torch.float32, device=q.device)
    lib = cuda_build.load("min_d2", _declare)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gto_min_d2(
            q.data_ptr(), 3 * M if q.dim() == 3 else 0, r4.data_ptr(), out.data_ptr(),
            B, M, N, tile_m, S, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"K1 launch (tile_m {tile_m}, split {S}) failed: {lib.gto_cuda_error_string(err).decode()}"
        )
    min_d2_launches += 1
    return out


def min_d2_occupancy(dev, tile_m, split):
    """(resident blocks per SM, clusters resident at once) of a K1 launch
    with this geometry on CUDA device `dev`."""
    lib = cuda_build.load("min_d2", _declare)
    blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = lib.gto_min_d2_occupancy(tile_m, split, ctypes.byref(blocks), ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f"K1 occupancy query failed: {lib.gto_cuda_error_string(err).decode()}")
    return blocks.value, clusters.value


def min_sqdist_d2(query, ref, ref_mask=None):
    """Batch-first dense SDF field-build primitive: (B, M) min squared
    distances from queries ((M, 3) shared or (B, M, 3)) to B reference
    clouds ref (B, N, 3) with optional validity masks (B, N). One K1
    launch on the card."""
    r4 = _pack_ref4(ref, ref_mask)
    return min_d2_batched(query.to(r4.dtype).contiguous(), r4)


# -- K2 / K3: nearest point, its index, normal --------------------------------


def nearest_batched_reference(q, r4, normals=None):
    """Plain-torch K2 / K3: q (M, 3) shared or (C, M, 3) per set; r4
    (C, N, 4) (see `_pack_ref4`); normals (C, N, 3) or None.

    Returns d2 (C, M) = max(0, min_n (|q - r_n|^2 + pen_n)) and its first
    argmin idx (C, M) int32; with normals also the nearest point (C, M, 3)
    and its normal (C, M, 3), copied from r4's rows and `normals`.
    Chunked over M like `min_d2_batched_reference`.
    """
    C, N, _ = r4.shape
    qb = q if q.dim() == 3 else q[None]
    M = qb.shape[1]
    rx, ry, rz, pen = (r4[:, None, :, i] for i in range(4))  # (C, 1, N)
    d2 = torch.empty((C, M), dtype=r4.dtype, device=r4.device)
    idx = torch.empty((C, M), dtype=torch.long, device=r4.device)
    chunk = max(1, _REFERENCE_CHUNK_ELEMS // max(C * N, 1))
    for m0 in range(0, M, chunk):
        qc = qb[:, m0 : m0 + chunk]
        acc = (qc[..., 0:1] - rx) ** 2
        acc = acc + (qc[..., 1:2] - ry) ** 2
        acc = acc + (qc[..., 2:3] - rz) ** 2
        acc = acc + pen
        # torch.min over a dim returns the first index of the minimum
        d2[:, m0 : m0 + chunk], idx[:, m0 : m0 + chunk] = torch.min(acc, dim=-1)
    d2 = torch.clamp(d2, min=0.0)
    if normals is None:
        return d2, idx.to(torch.int32)
    pt = torch.gather(r4[..., :3], 1, idx[..., None].expand(C, M, 3))
    nm = torch.gather(normals, 1, idx[..., None].expand(C, M, 3))
    return d2, idx.to(torch.int32), pt, nm


def nearest_batched(q, r4, normals=None, split=None):
    """K2 (with normals) or K3 (without): see `nearest_batched_reference`
    for shapes and outputs. One launch covers all C sets.

    CPU tensors take the plain version. CUDA tensors must be contiguous
    float32 on one device, r4 16-byte aligned, and launch
    `csrc/nearest.cu` once with `_k2_launch_plan`'s geometry; `split`
    forces the cluster size S (a power
    of two up to 16); the output is the same bits for every S. Anything
    else, and a launch the card refuses, raises.
    """
    global nearest_launches, min_sqdist_launches
    name = "K3" if normals is None else "K2"
    _check_shapes(name, q, r4)
    C, N, _ = r4.shape
    M = q.shape[-2]
    if normals is not None and tuple(normals.shape) != (C, N, 3):
        raise ValueError(f"normals must be {(C, N, 3)}, got {tuple(normals.shape)}")
    if split is not None:
        _k2_launch_plan(C, M, N, 1, split=split)  # validates it
    tensors = (q, r4) if normals is None else (q, r4, normals)
    if all(t.device.type == "cpu" for t in tensors):
        return nearest_batched_reference(q, r4, normals)
    _check_cuda(name, *tensors)
    if r4.data_ptr() % 16:
        raise ValueError(f"{name} takes r4 at a 16-byte aligned address")
    dev = q.device
    tile_m, S = _k2_launch_plan(C, M, N, *_k2_card(dev), split=split)
    d2 = torch.empty((C, M), dtype=torch.float32, device=dev)
    idx = torch.empty((C, M), dtype=torch.int32, device=dev)
    pt = nm = None
    if normals is not None:
        pt = torch.empty((C, M, 3), dtype=torch.float32, device=dev)
        nm = torch.empty((C, M, 3), dtype=torch.float32, device=dev)
    lib = cuda_build.load("nearest", _declare_nearest)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gto_nearest(
            q.data_ptr(), 3 * M if q.dim() == 3 else 0, r4.data_ptr(),
            None if normals is None else normals.data_ptr(),
            d2.data_ptr(), idx.data_ptr(),
            None if pt is None else pt.data_ptr(), None if nm is None else nm.data_ptr(),
            C, M, N, tile_m, S, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{name} launch (tile_m {tile_m}, split {S}) failed: {lib.gto_cuda_error_string(err).decode()}"
        )
    if normals is None:
        min_sqdist_launches += 1
        return d2, idx
    nearest_launches += 1
    return d2, idx, pt, nm


def nearest_occupancy(dev, N, tile_m, split):
    """(resident blocks per SM, clusters resident at once) of a K2 / K3
    launch with this geometry over N-point clouds on CUDA device `dev`."""
    lib = cuda_build.load("nearest", _declare_nearest)
    blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = lib.gto_nearest_occupancy(N, tile_m, split, ctypes.byref(blocks), ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f"K2 / K3 occupancy query failed: {lib.gto_cuda_error_string(err).decode()}")
    return blocks.value, clusters.value


def _batched(points, ref, ref_mask=None):
    """Shape adapter of the public K2 / K3 functions. Batch-first: points
    (C, ..., 3) against C sets ref (C, N, 3); or the JAX package's shapes:
    points (..., 3) against one set ref (K, 3). Returns (q (C, M, 3), r4,
    the output's leading shape)."""
    single = ref.dim() == 2
    if single:
        ref = ref[None]
        ref_mask = None if ref_mask is None else ref_mask[None]
    lead = points.shape[:-1]
    q = points.reshape(ref.shape[0], -1, 3).to(ref.dtype).contiguous()
    return q, _pack_ref4(ref, ref_mask), lead


def _nearest_point_normal(batched_fn, points, ref, normals):
    q, r4, lead = _batched(points, ref)
    nb = (normals[None] if normals.dim() == 2 else normals).to(r4.dtype).contiguous()
    d2, _, pt, nm = batched_fn(q, r4, nb)
    return d2.reshape(lead), pt.reshape(lead + (3,)), nm.reshape(lead + (3,))


def nearest_point_normal(points, ref, normals):
    """K2: (d2, nearest point, nearest normal) of points against padded
    reference sets with per-point normals (pad rows far away, e.g.
    PAD_COORD, never win). Shapes as in `_batched`; one launch."""
    return _nearest_point_normal(nearest_batched, points, ref, normals)


def nearest_point_normal_reference(points, ref, normals):
    """Plain-torch `nearest_point_normal`."""
    return _nearest_point_normal(nearest_batched_reference, points, ref, normals)


def min_sqdist(query, ref, ref_mask=None):
    """K3: (d2, first argmin int32) of queries against reference sets
    under an optional validity mask ((N,) or (C, N) bool). Shapes as in
    `_batched`. An all-invalid set gives d2 >= 1e38 and index 0."""
    q, r4, lead = _batched(query, ref, ref_mask)
    d2, idx = nearest_batched(q, r4)
    return d2.reshape(lead), idx.reshape(lead)


def min_sqdist_reference(query, ref, ref_mask=None):
    """Plain-torch `min_sqdist`."""
    q, r4, lead = _batched(query, ref, ref_mask)
    d2, idx = nearest_batched_reference(q, r4)
    return d2.reshape(lead), idx.reshape(lead)


def signed_distance_from_nearest(points, d2, nearest, normal, lateral_margin=0.05):
    """(sd, d(sd)/dp) from a query's nearest sample and that sample's
    normal (see `signed_distance_with_dir` for the sign rule)."""
    diff = points - nearest
    d_n = torch.sum(diff * normal, dim=-1)
    lat2 = torch.clamp(d2 - d_n * d_n, min=0.0)
    inside = (d_n < 0.0) & (lat2 <= lateral_margin * lateral_margin)
    sign = torch.where(inside, -1.0, 1.0).to(d2.dtype)
    sd = sign * torch.sqrt(torch.clamp(d2, min=1e-18))
    return sd, diff / sd[..., None]


def signed_distance_with_dir(points, ref, normals, lateral_margin=0.05):
    """(sd, d(sd)/dp) of points against padded point sets with per-point
    normals, from ONE K2 launch: callers contract the spatial gradient
    with their own point Jacobians.

    Sign: negative (inside) only when the query lies behind its nearest
    sample's normal AND within `lateral_margin` of that sample's surface
    footprint. A bare normal-dot sign calls everything behind the tangent
    plane inside, e.g. the robot base below a tabletop's top sheet, far to
    its side.
    """
    d2, nearest, n_star = nearest_point_normal(points, ref, normals)
    return signed_distance_from_nearest(points, d2, nearest, n_star, lateral_margin)


class _SignedDistanceToSet(torch.autograd.Function):
    """Signed distance with the exact piecewise gradient: the direction
    d(sd)/dp saved by the forward pass (the JAX package's custom_jvp). K2
    has no backward kernel: the backward pass is one product."""

    @staticmethod
    def forward(ctx, points, ref, normals):
        sd, dirs = signed_distance_with_dir(points, ref, normals)
        ctx.save_for_backward(dirs)
        return sd

    @staticmethod
    def backward(ctx, grad):
        (dirs,) = ctx.saved_tensors
        return grad[..., None] * dirs, None, None


def signed_distance_to_set(points, ref, normals):
    """Differentiable signed distance of points to padded point sets with
    normals; the sets are constants (scene geometry)."""
    return _SignedDistanceToSet.apply(points, ref, normals)
