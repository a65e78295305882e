"""Batched block-tridiagonal SPD solve (block Thomas / Cholesky recursion).

Port of grasptrajopt_tpu/ops/block_tridiag.py (`block_tridiag_solve`,
`block_tridiag_solve_cr`, `block_tridiag_matvec`). Any leading batch dims
are carried through (the time axis is -3 for blocks, -2 for vectors).

K5 (`block_tridiag_solve`): the Thomas solve of every LM iteration's KKT
system. On the card it is the hand-written CUDA kernel
`csrc/block_tridiag.cu`, the whole recursion for the whole batch in one
launch; its plain-torch version `block_tridiag_solve_reference` sits beside
it, a Python loop over T whose every step is a chain of small batched
launches (~18,300 a call at T = 48, n = 7). The wrapper takes the plain
version ONLY for tensors on the CPU; a CUDA tensor launches the kernel or
raises. The JAX package's solve is a `lax.scan`: K5 replaces no TPU kernel.

Cyclic reduction and the matvec stay plain torch: O(log T) batched
launches, and the matvec only in the two-pass iteration.
"""

from __future__ import annotations

import ctypes
import math

import torch

from grasptrajopt_tpu_torch.ops import cuda_build
from grasptrajopt_tpu_torch.ops.smallchol import (
    MAX_UNROLL_N,
    cholesky_small,
    cholesky_solve_small,
)

# K5 launches in this process (`block_tridiag_solve` on the card)
block_tridiag_launches = 0
# K5's block: 128 threads, 16 / 8 / 4 problems (n <= 7 / n <= 15 / n = 16);
# the grid is the batch over that
K5_THREADS = 128


def _block_linalg(n: int):
    """(cholesky, chol_solve) for (..., n, n) blocks: unrolled for tiny
    blocks, LAPACK-style above the unroll threshold."""
    if n <= MAX_UNROLL_N:
        return cholesky_small, cholesky_solve_small

    def chol_solve(chol, b):
        vec = b.dim() == chol.dim() - 1
        x = torch.cholesky_solve(b[..., None] if vec else b, chol)
        return x[..., 0] if vec else x

    return torch.linalg.cholesky, chol_solve


def block_tridiag_solve_reference(diag, lower, rhs):
    """Plain-torch K5: solve H x = rhs with H SPD block-tridiagonal.

    diag (..., T, n, n) diagonal blocks; lower (..., T-1, n, n) sub-diagonal
    blocks L_t = H[t+1, t]; rhs (..., T, n). Returns x (..., T, n), by the
    block LDL^T (Schur) recursion
        S_0 = D_0,  S_t = D_t - L_{t-1} S_{t-1}^{-1} L_{t-1}^T.
    """
    T, n = diag.shape[-3], diag.shape[-1]
    cholesky, chol_solve = _block_linalg(n)

    chol = cholesky(diag[..., 0, :, :])
    y = rhs[..., 0, :]
    chols, ys = [chol], [y]
    for t in range(1, T):
        L_prev = lower[..., t - 1, :, :]
        W = chol_solve(chol, L_prev.transpose(-1, -2))  # S_{t-1}^{-1} L_{t-1}^T
        S = diag[..., t, :, :] - L_prev @ W
        y = rhs[..., t, :] - (L_prev @ chol_solve(chol, y)[..., None])[..., 0]
        chol = cholesky(S)
        chols.append(chol)
        ys.append(y)

    x = chol_solve(chols[-1], ys[-1])
    xs = [x]
    for t in range(T - 2, -1, -1):
        L_t = lower[..., t, :, :]
        x = chol_solve(chols[t], ys[t] - (L_t.transpose(-1, -2) @ x[..., None])[..., 0])
        xs.append(x)
    return torch.stack(xs[::-1], dim=-2)


def _declare(lib):
    # every pointer and the stream as c_void_p: ctypes would cut a plain
    # int argument to 32 bits
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gto_block_tridiag.argtypes = [p, p, ll, ll, ll, ll, p, p, p, i, i, i, i, i, p]
    lib.gto_block_tridiag.restype = ctypes.c_int
    lib.gto_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gto_cuda_error_string.restype = ctypes.c_char_p


def k5_operands(diag, lower, rhs):
    """(B, F, n, lower4): K5's problem count (the leading dims flattened),
    blocks, block size and `lower` as a (B, F - 1, n, n) view whose strides
    the kernel reads (the solver's expanded -w I has stride 0: no copy).
    Raises on what the kernel does not take: another dtype than float32 /
    float64 or mixed dtypes, n outside 1..MAX_UNROLL_N, shapes that do not
    match, no blocks, a non-contiguous `diag` or `rhs`, inputs that need a
    gradient."""
    if diag.dim() < 3 or diag.shape[-1] != diag.shape[-2]:
        raise ValueError(f"K5 takes diag (..., F, n, n), got {tuple(diag.shape)}")
    lead, F, n = tuple(diag.shape[:-3]), diag.shape[-3], diag.shape[-1]
    if tuple(lower.shape) != lead + (F - 1, n, n) or tuple(rhs.shape) != lead + (F, n):
        raise ValueError(
            f"K5 takes diag (..., F, n, n), lower (..., F-1, n, n), rhs (..., F, n); got "
            f"{tuple(diag.shape)}, {tuple(lower.shape)}, {tuple(rhs.shape)}"
        )
    dtypes = {diag.dtype, lower.dtype, rhs.dtype}
    if len(dtypes) != 1 or diag.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K5 takes float32 or float64 blocks of one dtype, got {[str(d) for d in dtypes]}")
    if not 1 <= n <= MAX_UNROLL_N:
        raise ValueError(f"K5 takes blocks of 1 to {MAX_UNROLL_N} rows, got n = {n}")
    if F < 1:
        raise ValueError("K5 needs at least one block")
    if not (diag.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("K5 takes a contiguous diag and rhs")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (diag, lower, rhs)):
        raise RuntimeError("K5 has no backward: solve outside autograd")
    B = math.prod(lead)
    return B, F, n, lower.reshape((B, F - 1, n, n))


def block_tridiag_solve(diag, lower, rhs):
    """K5: solve H x = rhs with H SPD block-tridiagonal; see
    `block_tridiag_solve_reference` for the layout and the recursion.

    CPU tensors take the plain version. On the card, diag and rhs must be
    contiguous, all three float32 or float64 on one device, 1 <= n <= 16
    (MAX_UNROLL_N) and F >= 1 (`k5_operands`); that launches
    `csrc/block_tridiag.cu` once on the current stream, with no read back
    to the host. Anything else raises.
    """
    global block_tridiag_launches
    tensors = (diag, lower, rhs)
    if all(t.device.type == "cpu" for t in tensors):
        return block_tridiag_solve_reference(diag, lower, rhs)
    dev = diag.device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"K5 needs its tensors on one CUDA device, got {[str(t.device) for t in tensors]}")
    B, F, n, lower4 = k5_operands(diag, lower, rhs)
    x = torch.empty(rhs.shape, dtype=rhs.dtype, device=dev)
    if B == 0:
        return x
    fac = torch.empty((B, F, n, n), dtype=diag.dtype, device=dev)  # the factors C_t
    lib = cuda_build.load("block_tridiag", _declare)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gto_block_tridiag(
            diag.data_ptr(), lower4.data_ptr(), *lower4.stride(), rhs.data_ptr(), x.data_ptr(),
            fac.data_ptr(), B, F, n, int(diag.dtype == torch.float64), K5_THREADS, stream,
        )
    if err != 0:
        raise RuntimeError(f"K5 launch failed: {lib.gto_cuda_error_string(err).decode()}")
    block_tridiag_launches += 1
    return x


def block_tridiag_solve_cr(diag, lower, rhs):
    """The system of `block_tridiag_solve` (same signature and result) by
    parallel-in-time block cyclic reduction: each level eliminates the
    even-indexed blocks with ONE batched Cholesky over them (and over the
    batch), so the T-step chain becomes ceil(log2(T + 1)) levels.

    The system is padded with decoupled identity blocks to 2^k - 1 blocks;
    each reduced diagonal is a Schur complement of an SPD matrix, so it
    stays SPD.
    """
    T, n = diag.shape[-3], diag.shape[-1]
    lead = diag.shape[:-3]
    dtype, dev = diag.dtype, diag.device
    cholesky, chol_solve = _block_linalg(n)
    k = 1
    while (1 << k) - 1 < T:
        k += 1
    M = (1 << k) - 1
    eye = torch.eye(n, dtype=dtype, device=dev)
    D = torch.cat([diag, eye.expand(lead + (M - T, n, n))], dim=-3)
    # L[t] couples t -> t + 1; M blocks with zeros past the real couplings
    L = torch.cat([lower, torch.zeros(lead + (M - T + 1, n, n), dtype=dtype, device=dev)], dim=-3)
    b = torch.cat([rhs, torch.zeros(lead + (M - T, n), dtype=dtype, device=dev)], dim=-2)

    def mv(A, v):
        return (A @ v[..., None])[..., 0]

    def reduce(D, L, b):
        """One level: eliminate the even (0-based) blocks of an m = 2^j - 1
        system; returns the half-size system and what back-substitution
        needs."""
        F = cholesky(D[..., 0::2, :, :])  # (p, n, n) even diagonals
        r = chol_solve(F, b[..., 0::2, :])  # E^-1 b_even
        A = L[..., 0::2, :, :]  # A[i] = L[2i]: even 2i -> odd 2i + 1
        Bc = L[..., 1::2, :, :]  # Bc[i] = L[2i + 1]: odd 2i + 1 -> even 2i + 2
        X = chol_solve(F[..., :-1, :, :], A[..., :-1, :, :].transpose(-1, -2))
        Y = chol_solve(F[..., 1:, :, :], Bc)
        BcT = Bc.transpose(-1, -2)
        D2 = D[..., 1::2, :, :] - A[..., :-1, :, :] @ X - BcT @ Y
        b2 = b[..., 1::2, :] - mv(A[..., :-1, :, :], r[..., :-1, :]) - mv(BcT, r[..., 1:, :])
        # consecutive odds couple through the even between them
        L2 = torch.cat([-(A[..., 1:-1, :, :] @ Y[..., :-1, :, :]), torch.zeros_like(D2[..., :1, :, :])], dim=-3)
        return (D2, L2, b2), (F, A, Bc)

    def backsub(x_odd, F, A, Bc, b):
        """The even unknowns of a level from its solved odd ones."""
        p = F.shape[-3]
        zv = torch.zeros_like(b[..., :1, :])
        xo = torch.cat([zv, x_odd, zv], dim=-2)  # ghosts x_{-1}, x_m
        Bl = torch.cat([torch.zeros_like(F[..., :1, :, :]), Bc], dim=-3)
        rhs_e = b[..., 0::2, :] - mv(Bl, xo[..., :p, :]) - mv(A.transpose(-1, -2), xo[..., 1 : p + 1, :])
        out = torch.empty(lead + (2 * p - 1, n), dtype=dtype, device=dev)
        out[..., 0::2, :] = chol_solve(F, rhs_e)
        out[..., 1::2, :] = x_odd
        return out

    stack = []
    while D.shape[-3] > 1:
        (D2, L2, b2), saved = reduce(D, L, b)
        stack.append((saved, b))
        D, L, b = D2, L2, b2
    x = chol_solve(cholesky(D), b)  # (..., 1, n)
    for (F, A, Bc), b_level in reversed(stack):
        x = backsub(x, F, A, Bc, b_level)
    return x[..., :T, :]


def block_tridiag_matvec(diag, lower, x):
    """H @ x for the same block-tridiagonal layout."""
    y = torch.einsum("...tij,...tj->...ti", diag, x)
    below = torch.einsum("...tij,...tj->...ti", lower, x[..., :-1, :])
    above = torch.einsum("...tji,...tj->...ti", lower, x[..., 1:, :])
    zero = torch.zeros_like(x[..., :1, :])
    return y + torch.cat([zero, below], dim=-2) + torch.cat([above, zero], dim=-2)
