"""K1 on the card: the hand-written CUDA kernel against its plain-torch
version on the same CUDA tensors. Marked `gpu`; every test skips where
there is no CUDA device. Run on the card with

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerance 1e-5 m^2: squared distances in the workspace are below ~10 m^2
and the kernel's fused multiply-adds may move a value by a few ulp
(~1e-6 at that scale) against the plain version's rounding.
"""

import numpy as np
import pytest
import torch

from grasptrajopt_tpu_torch.ops import nn

pytestmark = pytest.mark.gpu
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, B, M, N, per_cloud=False, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.rand((B, M, 3) if per_cloud else (M, 3), generator=g) * 2 - 1
    r = torch.rand((B, N, 3), generator=g) * 2 - 1
    mask = torch.rand((B, N), generator=g) > 0.3
    return q.to(dev), nn._pack_refT(r.to(dev), mask.to(dev))


@pytest.mark.parametrize(
    "B,M,N,per_cloud",
    [
        (16, 95_760, 2_048, False),  # slice widths: target pass
        (3, 1_000, 1_000, False),  # ragged M and N: not multiples of the tiles
        (2, 1, 1, False),
        (4, 3_200, 12_288, True),  # the grasp pre-filter's per-object queries
    ],
)
def test_kernel_matches_plain(cuda, B, M, N, per_cloud):
    q, rT = _inputs(cuda, B, M, N, per_cloud)
    before = nn.min_d2_launches
    got = nn.min_d2_batched(q, rT)
    torch.cuda.synchronize()
    assert nn.min_d2_launches == before + 1
    want = nn.min_d2_batched_reference(q, rT)
    assert got.shape == (B, M)
    assert float((got - want).abs().max()) <= TOL


def test_all_invalid_cloud_gives_penalty(cuda):
    q, rT = _inputs(cuda, 3, 777, 2_100)
    rT[1, 3] = nn.PENALTY_BIG  # cloud 1: every point invalid
    got = nn.min_d2_batched(q, rT)
    want = nn.min_d2_batched_reference(q, rT)
    torch.cuda.synchronize()
    assert torch.all(got[1] == want[1])
    assert torch.all(got[1] >= 1e38)
    assert float((got[[0, 2]] - want[[0, 2]]).abs().max()) <= TOL


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, rT = _inputs(cuda, 2, 100, 100)
    before = nn.min_d2_launches
    with pytest.raises(TypeError):
        nn.min_d2_batched(q.double(), rT.double())
    with pytest.raises(ValueError):
        nn.min_d2_batched(q.cpu(), rT)
    with pytest.raises(ValueError):
        nn.min_d2_batched(q, rT[:, :, ::2])  # not contiguous
    assert nn.min_d2_launches == before


def test_min_sqdist_d2_is_exact_near_the_surface(cuda):
    """Queries 1 mm from cloud points at workspace coordinates: the exact
    subtract-square form keeps the distance; the matmul expansion would
    lose it to cancellation."""
    g = torch.Generator().manual_seed(1)
    ref = (torch.rand((1, 4_096, 3), generator=g) + torch.tensor([0.5, -0.5, 0.7])).to(cuda)
    q = ref[0, :1_000] + torch.tensor([1e-3, 0.0, 0.0], device=cuda)
    d = torch.sqrt(nn.min_sqdist_d2(q, ref)).cpu().double()
    want = torch.sqrt(nn.min_sqdist_d2(q.cpu().double(), ref.cpu().double()))
    assert float(d.max()) <= 1.001e-3
    np.testing.assert_allclose(d.numpy(), want.numpy(), atol=1e-7, rtol=0)
