"""Exact-fp32 brute-force minimum squared distance: kernel K1.

Port of grasptrajopt_tpu/ops/nn.py (`min_d2_batched_pallas`,
`_pack_refT`, `min_sqdist_d2`). The dense SDF field build asks, for each
of M query points, the squared distance to the nearest valid point of
each of B reference clouds. On the card this is the hand-written CUDA
kernel `csrc/min_d2.cu`; `min_d2_batched_reference` is the same function
in plain torch beside it. `min_d2_batched` takes the plain version ONLY
for tensors on the CPU; a CUDA tensor launches the kernel or raises.

Distances are always the three broadcast subtract-squares in the working
precision, never the |q|^2 + |r|^2 - 2 q.r expansion, which cancels
catastrophically near the surface.

Callers are batch-first: one call covers every cloud of the batch, so each
field pass is ONE kernel launch.
"""

from __future__ import annotations

import ctypes

import torch

from grasptrajopt_tpu_torch.ops import cuda_build

# penalty of an invalid reference point (the JAX package's _PAL_BIG)
PENALTY_BIG = 3.0e38

# number of K1 kernel launches made by `min_d2_batched` in this process
min_d2_launches = 0

_REFERENCE_CHUNK_ELEMS = 1 << 24  # (batch x queries x points) per plain chunk


def _pack_refT(ref, ref_mask=None):
    """(B, N, 3) [+ (B, N) bool mask] -> (B, 4, N) rows x / y / z /
    penalty (0 valid, PENALTY_BIG invalid). No padding: K1 masks the
    ragged edge itself."""
    pen = torch.zeros(ref.shape[:-1], dtype=ref.dtype, device=ref.device)
    if ref_mask is not None:
        pen = torch.where(ref_mask, pen, torch.full_like(pen, PENALTY_BIG))
    return torch.cat([ref.transpose(-1, -2), pen[:, None, :]], dim=1).contiguous()


def min_d2_batched_reference(q, rT):
    """Plain-torch K1: q (M, 3) shared or (B, M, 3) per cloud; rT (B, 4, N).
    Returns (B, M) = max(0, min_n (|q - r_n|^2 + pen_n)).

    Chunked over M so the (B, M, N) distance tensor never materializes
    (at the field build's widths it would be 4.7 GB per cloud).
    """
    B, _, N = rT.shape
    qb = q if q.dim() == 3 else q[None]
    M = qb.shape[1]
    rx, ry, rz, pen = (rT[:, i, None, :] for i in range(4))  # (B, 1, N)
    out = torch.empty((B, M), dtype=rT.dtype, device=rT.device)
    chunk = max(1, _REFERENCE_CHUNK_ELEMS // max(B * N, 1))
    for m0 in range(0, M, chunk):
        qc = qb[:, m0 : m0 + chunk]
        acc = (qc[..., 0:1] - rx) ** 2
        acc = acc + (qc[..., 1:2] - ry) ** 2
        acc = acc + (qc[..., 2:3] - rz) ** 2
        acc = acc + pen
        out[:, m0 : m0 + chunk] = torch.amin(acc, dim=-1)
    return torch.clamp(out, min=0.0)


def _declare(lib):
    # every pointer and the stream as c_void_p: ctypes would cut a plain
    # int argument to 32 bits
    lib.gto_min_d2.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.gto_min_d2.restype = ctypes.c_int
    lib.gto_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gto_cuda_error_string.restype = ctypes.c_char_p


def _check_shapes(q, rT):
    if rT.dim() != 3 or rT.shape[1] != 4:
        raise ValueError(f"rT must be (B, 4, N), got {tuple(rT.shape)}")
    if q.dim() not in (2, 3) or q.shape[-1] != 3:
        raise ValueError(f"q must be (M, 3) or (B, M, 3), got {tuple(q.shape)}")
    if q.dim() == 3 and q.shape[0] != rT.shape[0]:
        raise ValueError(f"per-cloud queries {tuple(q.shape)} do not match rT {tuple(rT.shape)}")
    if q.shape[-2] == 0 or rT.shape[2] == 0:
        raise ValueError("K1 needs at least one query and one reference point")


def min_d2_batched(q, rT):
    """K1: (B, M) min squared distances of q ((M, 3) shared or (B, M, 3))
    to the B reference sets of rT ((B, 4, N), see `_pack_refT`).

    CPU tensors take `min_d2_batched_reference`. CUDA tensors must be
    contiguous float32 on one device and launch the kernel; anything else
    raises.
    """
    global min_d2_launches
    _check_shapes(q, rT)
    if q.device.type == "cpu" and rT.device.type == "cpu":
        return min_d2_batched_reference(q, rT)
    if not (q.is_cuda and rT.is_cuda and q.device == rT.device):
        raise ValueError(f"K1 needs q and rT on one CUDA device, got {q.device} and {rT.device}")
    if q.dtype != torch.float32 or rT.dtype != torch.float32:
        raise TypeError(f"K1 takes float32, got {q.dtype} and {rT.dtype}")
    if not (q.is_contiguous() and rT.is_contiguous()):
        raise ValueError("K1 takes contiguous tensors")
    B, _, N = rT.shape
    M = q.shape[-2]
    out = torch.empty((B, M), dtype=torch.float32, device=q.device)
    lib = cuda_build.load("min_d2", _declare)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gto_min_d2(
            q.data_ptr(), 3 * M if q.dim() == 3 else 0, rT.data_ptr(), out.data_ptr(),
            B, M, N, stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: {lib.gto_cuda_error_string(err).decode()}")
    min_d2_launches += 1
    return out


def min_sqdist_d2(query, ref, ref_mask=None):
    """Batch-first dense SDF field-build primitive: (B, M) min squared
    distances from queries ((M, 3) shared or (B, M, 3)) to B reference
    clouds ref (B, N, 3) with optional validity masks (B, N). One K1
    launch on the card."""
    rT = _pack_refT(ref, ref_mask)
    return min_d2_batched(query.to(rT.dtype).contiguous(), rT)
