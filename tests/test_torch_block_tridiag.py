"""K5's wrapper on the CPU: CPU tensors take the plain loop unchanged (no
launch counted), and `k5_operands` (what the kernel is handed) flattens
the leading dims, reads the solver's expanded -w I through its strides
without a copy, and refuses what the kernel does not take. The kernel
itself is held to the plain loop on the card (tests/test_torch_gpu.py)."""

import pytest
import torch

from grasptrajopt_tpu_torch.ops import block_tridiag as bt


def _system(lead, F, n, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(lead + (F, n, n), generator=g, dtype=dtype)
    D = A @ A.transpose(-1, -2) + (2 * n + 2) * torch.eye(n, dtype=dtype)
    L = 0.3 * torch.randn(lead + (F - 1, n, n), generator=g, dtype=dtype)
    rhs = torch.randn(lead + (F, n), generator=g, dtype=dtype)
    return D, L, rhs


@pytest.mark.parametrize("lead,F,n", [((4,), 12, 7), ((2, 3), 5, 3), ((), 6, 1), ((2,), 1, 16), ((2,), 4, 20)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cpu_tensors_take_the_plain_loop(lead, F, n, dtype):
    D, L, rhs = _system(lead, F, n, dtype)
    before = bt.block_tridiag_launches
    x = bt.block_tridiag_solve(D, L, rhs)
    assert bt.block_tridiag_launches == before
    assert torch.equal(x, bt.block_tridiag_solve_reference(D, L, rhs))
    assert x.shape == rhs.shape and x.dtype == dtype


def test_plain_loop_solves_the_system():
    """The plain loop against a dense solve of the assembled matrix, with
    the solver's expanded -w I couplings."""
    F, n, w = 9, 7, 0.8
    D, _, rhs = _system((3,), F, n)
    L = (-w * torch.eye(n, dtype=torch.float64)).expand(3, F - 1, n, n)
    x = bt.block_tridiag_solve(D, L, rhs)
    H = torch.zeros(3, F * n, F * n, dtype=torch.float64)
    for t in range(F):
        H[:, t * n:(t + 1) * n, t * n:(t + 1) * n] = D[:, t]
    for t in range(F - 1):
        H[:, (t + 1) * n:(t + 2) * n, t * n:(t + 1) * n] = L[:, t]
        H[:, t * n:(t + 1) * n, (t + 1) * n:(t + 2) * n] = L[:, t].transpose(-1, -2)
    want = torch.linalg.solve(H, rhs.reshape(3, F * n)).reshape(3, F, n)
    assert float((x - want).abs().max()) <= 1e-12


def test_operands_read_the_expanded_lower_through_its_strides():
    F, n, B = 48, 7, 2_048
    D, _, rhs = _system((B,), F, n, torch.float32)
    L = (-2.0 * torch.eye(n)).expand(B, F - 1, n, n)
    got_B, got_F, got_n, lower4 = bt.k5_operands(D, L, rhs)
    assert (got_B, got_F, got_n) == (B, F, n)
    assert lower4.data_ptr() == L.data_ptr() and lower4.stride() == (0, 0, n, 1)
    # two leading dims flatten into one, still a view
    D2, L2, r2 = _system((2, 3), 5, 4)
    B2, _, _, low2 = bt.k5_operands(D2, L2, r2)
    assert B2 == 6 and low2.shape == (6, 4, 4, 4) and low2.data_ptr() == L2.data_ptr()
    Le = (-torch.eye(4, dtype=torch.float64)).expand(2, 3, 4, 4, 4)
    assert bt.k5_operands(D2, Le, r2)[3].stride() == (0, 0, 4, 1)


def test_operands_refuse_what_the_kernel_does_not_take():
    D, L, rhs = _system((3,), 6, 7)
    with pytest.raises(ValueError):  # n = 17
        bt.k5_operands(*_system((3,), 6, 17))
    with pytest.raises(TypeError):
        bt.k5_operands(D.half(), L.half(), rhs.half())
    with pytest.raises(TypeError):  # mixed dtypes
        bt.k5_operands(D, L.float(), rhs)
    with pytest.raises(ValueError):  # 6 blocks, 4 couplings
        bt.k5_operands(D, L[:, :4], rhs)
    with pytest.raises(ValueError):  # 6 blocks, 5 right-hand sides
        bt.k5_operands(D, L, rhs[:, :5])
    with pytest.raises(ValueError):  # a non-contiguous diag
        bt.k5_operands(D.transpose(-1, -2), L, rhs)
    with pytest.raises(ValueError):  # a non-contiguous rhs
        bt.k5_operands(D, L, torch.randn(3, 7, 6, dtype=torch.float64).transpose(-1, -2))
    with pytest.raises(ValueError):  # no blocks
        bt.k5_operands(D[:, :0], torch.zeros(3, 0, 7, 7, dtype=torch.float64), rhs[:, :0])
    with pytest.raises(RuntimeError):  # K5 has no backward
        bt.k5_operands(D.requires_grad_(), L, rhs)
