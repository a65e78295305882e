"""Batched block-tridiagonal SPD solve (block Thomas / Cholesky recursion).

Port of grasptrajopt_tpu/ops/block_tridiag.py (`block_tridiag_solve`,
`block_tridiag_solve_cr`, `block_tridiag_matvec`). Each `lax.scan` over
time is a Python loop over T here, so one Thomas solve is O(T) small
launches on the card and one cyclic-reduction solve O(log T); a kernel or
a CUDA graph for it is later work. Any leading batch dims are carried
through (the time axis is -3 for blocks, -2 for vectors).
"""

from __future__ import annotations

import torch

from grasptrajopt_tpu_torch.ops.smallchol import (
    MAX_UNROLL_N,
    cholesky_small,
    cholesky_solve_small,
)


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


def block_tridiag_solve(diag, lower, rhs):
    """Solve H x = rhs with H SPD block-tridiagonal.

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
