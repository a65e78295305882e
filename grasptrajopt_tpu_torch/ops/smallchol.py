"""Unrolled Cholesky + triangular substitution for tiny SPD blocks.

Port of grasptrajopt_tpu/ops/smallchol.py: column-by-column factorization
and substitution as (batch,)-wide elementwise ops over leading dims, for
the n <= 16 blocks the solvers use (7 for the synthetic arm). Functional
(no in-place writes) and dtype-polymorphic.
"""

from __future__ import annotations

import torch

MAX_UNROLL_N = 16


def cholesky_small(A):
    """Lower Cholesky factor of SPD A (..., n, n), unrolled over n."""
    n = A.shape[-1]
    rows = torch.arange(n, device=A.device)
    cols = []
    for j in range(n):
        v = A[..., :, j]
        for k in range(j):
            v = v - cols[k] * cols[k][..., j : j + 1]
        d = torch.sqrt(v[..., j : j + 1])
        # rows above the diagonal are structural zeros of L
        cols.append(torch.where(rows >= j, v / d, torch.zeros_like(v)))
    return torch.stack(cols, dim=-1)


def solve_triangular_lower_small(L, B):
    """Solve L Y = B by forward substitution; B (..., n) or (..., n, m)."""
    vec = B.dim() == L.dim() - 1
    if vec:
        B = B[..., None]
    n = L.shape[-1]
    ys = []
    for i in range(n):
        r = B[..., i, :]
        for k in range(i):
            r = r - L[..., i, k : k + 1] * ys[k]
        ys.append(r / L[..., i, i : i + 1])
    Y = torch.stack(ys, dim=-2)
    return Y[..., 0] if vec else Y


def solve_triangular_upper_small(U, B):
    """Solve U Y = B (U upper-triangular) by back substitution."""
    vec = B.dim() == U.dim() - 1
    if vec:
        B = B[..., None]
    n = U.shape[-1]
    ys = [None] * n
    for i in range(n - 1, -1, -1):
        r = B[..., i, :]
        for k in range(i + 1, n):
            r = r - U[..., i, k : k + 1] * ys[k]
        ys[i] = r / U[..., i, i : i + 1]
    Y = torch.stack(ys, dim=-2)
    return Y[..., 0] if vec else Y


def cholesky_solve_small(L, B):
    """Solve (L L^T) X = B given the lower factor L."""
    Y = solve_triangular_lower_small(L, B)
    return solve_triangular_upper_small(L.transpose(-1, -2), Y)
