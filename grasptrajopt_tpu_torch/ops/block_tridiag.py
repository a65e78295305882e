"""Batched block-tridiagonal SPD solve (block Thomas / Cholesky recursion).

Port of grasptrajopt_tpu/ops/block_tridiag.py (`block_tridiag_solve`,
`block_tridiag_matvec`). Each `lax.scan` over time is a Python loop over
T here, so one solve is O(T) small launches on the card; a kernel or a
CUDA graph for it is later work. Any leading batch dims are carried
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


def block_tridiag_matvec(diag, lower, x):
    """H @ x for the same block-tridiagonal layout."""
    y = torch.einsum("...tij,...tj->...ti", diag, x)
    below = torch.einsum("...tij,...tj->...ti", lower, x[..., :-1, :])
    above = torch.einsum("...tji,...tj->...ti", lower, x[..., 1:, :])
    zero = torch.zeros_like(x[..., :1, :])
    return y + torch.cat([zero, below], dim=-2) + torch.cat([above, zero], dim=-2)
