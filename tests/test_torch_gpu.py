"""K1-K5 on the card: the hand-written CUDA kernels against their
plain-torch versions on the same CUDA tensors; K1 and K2 / K3 at every
cluster split. Marked `gpu`; every test
skips where there is no CUDA device. Run on the card with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

Tolerance 1e-5 m^2: squared distances in the workspace are below ~10 m^2
and the kernel's fused multiply-adds may move a value by a few ulp
(~1e-6 at that scale) against the plain version's rounding. Above 10 m^2
(PAD_COORD rows, ~3e12 m^2) K2 / K3 are held to 1e-6 relative. Their
index may differ from plain's only where two rows are that near to equal.
"""

import numpy as np
import pytest
import torch

from grasptrajopt_tpu_torch.fields.scene_points import PAD_COORD
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
    return q.to(dev), nn._pack_ref4(r.to(dev), mask.to(dev))


@pytest.mark.parametrize(
    "B,M,N,per_cloud",
    [
        (16, 95_760, 2_048, False),  # slice widths: target pass
        (3, 1_000, 1_000, False),  # ragged M and N: not multiples of the tiles
        (2, 1, 1, False),
        (4, 9_600, 12_288, True),  # the grasp pre-filter's per-object queries (32 grasps x 300 points)
        (1, 95_760, 25_600, False),  # the pipeline's B = 1 field build
        (1, 50_000, 25_600, False),  # one plan's replay
        (1, 50_000, 51_200, False),  # a replay over two fused views
        (1, 9_600, 25_600, False),  # the grasp filter
        (1, 20_001, 3 * 8 * 512 + 77, False),  # ragged N: not a multiple of S x the point tile
    ],
)
def test_kernel_matches_plain(cuda, B, M, N, per_cloud):
    q, r4 = _inputs(cuda, B, M, N, per_cloud)
    before = nn.min_d2_launches
    got = nn.min_d2_batched(q, r4)
    torch.cuda.synchronize()
    assert nn.min_d2_launches == before + 1
    want = nn.min_d2_batched_reference(q, r4)
    assert got.shape == (B, M)
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("B,M,N", [(1, 95_760, 25_600), (1, 9_600, 25_600), (2, 3_001, 3 * 8 * 512 + 77)])
def test_every_split_gives_the_same_bits(cuda, B, M, N):
    """The min is exact and order-free: every forced cluster size S gives
    the chosen plan's output bit for bit."""
    q, r4 = _inputs(cuda, B, M, N, seed=5)
    planned = nn.min_d2_batched(q, r4)
    for split in (1, 2, 4, 8):
        assert torch.equal(nn.min_d2_batched(q, r4, split=split), planned), split


def test_all_invalid_cloud_gives_penalty(cuda):
    q, r4 = _inputs(cuda, 3, 777, 2_100)
    r4[1, :, 3] = nn.PENALTY_BIG  # cloud 1: every point invalid
    want = nn.min_d2_batched_reference(q, r4)
    for split in (None, 4):
        got = nn.min_d2_batched(q, r4, split=split)
        torch.cuda.synchronize()
        assert torch.all(got[1] == want[1])
        assert torch.all(got[1] >= 1e38)
        assert float((got[[0, 2]] - want[[0, 2]]).abs().max()) <= TOL


def test_all_invalid_cloud_split_at_b1(cuda):
    q, r4 = _inputs(cuda, 1, 9_600, 25_600)
    r4[0, :, 3] = nn.PENALTY_BIG
    assert nn._k1_launch_plan(1, 9_600, 25_600, *nn._k1_card(q.device))[1] > 1
    got = nn.min_d2_batched(q, r4)
    torch.cuda.synchronize()
    assert torch.equal(got, nn.min_d2_batched_reference(q, r4))


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, r4 = _inputs(cuda, 2, 100, 100)
    before = nn.min_d2_launches
    with pytest.raises(TypeError):
        nn.min_d2_batched(q.double(), r4.double())
    with pytest.raises(ValueError):
        nn.min_d2_batched(q.cpu(), r4)
    with pytest.raises(ValueError):
        nn.min_d2_batched(q, r4[:, ::2])  # not contiguous
    with pytest.raises(ValueError):
        nn.min_d2_batched(q, r4, split=3)
    with pytest.raises(ValueError):  # 4 bytes past an aligned address
        nn.min_d2_batched(q, r4.reshape(-1)[1 : 1 + 2 * 99 * 4].view(2, 99, 4))
    assert nn.min_d2_launches == before


@pytest.mark.parametrize("plan", [(256, 16), (1024, 1)])
def test_refused_launch_raises(cuda, monkeypatch, plan):
    """A geometry the card refuses (a cluster beyond the portable 8, a
    block beyond the kernel's launch bounds) raises from the launch; the
    wrapper never hands back another path's output."""
    q, r4 = _inputs(cuda, 1, 5_000, 8_192)
    monkeypatch.setattr(nn, "_k1_launch_plan", lambda *a, **k: plan)
    before = nn.min_d2_launches
    with pytest.raises(RuntimeError, match="K1 launch"):
        nn.min_d2_batched(q, r4)
    assert nn.min_d2_launches == before
    monkeypatch.undo()
    torch.cuda.synchronize()  # the refusal left no error behind
    assert float((nn.min_d2_batched(q, r4) - nn.min_d2_batched_reference(q, r4)).abs().max()) <= TOL


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


def _nearest_inputs(dev, C, M, N, seed=0, n_pad=0, valid=None):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.rand((C, M, 3), generator=g) * 2 - 1
    r = torch.rand((C, N, 3), generator=g) * 2 - 1
    r[:, N - n_pad :] = PAD_COORD
    nrm = torch.nn.functional.normalize(torch.randn((C, N, 3), generator=g), dim=-1)
    mask = None if valid is None else torch.rand((C, N), generator=g) < valid
    r4 = nn._pack_ref4(r.to(dev), None if mask is None else mask.to(dev))
    return q.to(dev), r4, nrm.to(dev)


def _check_nearest(q, r4, nrm, got, want):
    """d2 to tolerance; the kernel's row as near as plain's (float64);
    point and normal bit-equal to that row."""
    C, N, _ = r4.shape
    qb = q if q.dim() == 3 else q[None]
    M = qb.shape[1]
    d2k, idxk, d2p, idxp = got[0].double(), got[1].long(), want[0].double(), want[1].long()
    tol = torch.where(d2p < 10, torch.full_like(d2p, TOL), 1e-6 * d2p)
    assert bool(((d2k - d2p).abs() <= tol).all())
    assert bool(((idxk >= 0) & (idxk < N)).all())

    def row_d2(idx):
        rows = torch.gather(r4, 1, idx[..., None].expand(C, M, 4)).double()
        return ((qb.double() - rows[..., :3]) ** 2).sum(-1) + rows[..., 3]

    assert bool(((row_d2(idxk) - row_d2(idxp)).abs() <= tol).all())
    if nrm is not None:
        assert torch.equal(got[2], torch.gather(r4[..., :3], 1, idxk[..., None].expand(C, M, 3)))
        assert torch.equal(got[3], torch.gather(nrm, 1, idxk[..., None].expand(C, M, 3)))


@pytest.mark.parametrize(
    "C,M,N,n_pad,with_normals",
    [
        (4, 50_000, 4_096, 400, True),  # the exact tier's obstacle set, padded
        (3, 1, 1, 0, True),  # ragged M and N
        (2, 1_025, 4_097, 0, True),
        (5, 1_000, 1_000, 0, False),  # K3
        (2, 2_049, 2_048, 10, False),
    ],
)
def test_nearest_kernel_matches_plain(cuda, C, M, N, n_pad, with_normals):
    q, r4, nrm = _nearest_inputs(cuda, C, M, N, n_pad=n_pad)
    normals = nrm if with_normals else None
    k2, k3 = nn.nearest_launches, nn.min_sqdist_launches
    got = nn.nearest_batched(q, r4, normals)
    torch.cuda.synchronize()
    assert (nn.nearest_launches - k2, nn.min_sqdist_launches - k3) == ((1, 0) if with_normals else (0, 1))
    want = nn.nearest_batched_reference(q, r4, normals)
    assert len(got) == len(want) == (4 if with_normals else 2)
    _check_nearest(q, r4, normals, got, want)


def _occupancy_like(dev, M, N, seed=0):
    """The occupancy build's inputs at its shapes: grid cells and view
    points in a plane (z = 0), shared queries."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.cat([torch.rand((M, 2), generator=g) * 3 - 1.5, torch.zeros((M, 1))], dim=1)
    r = torch.cat([torch.rand((1, N, 2), generator=g) * 3 - 1.5, torch.zeros((1, N, 1))], dim=2)
    return q.to(dev), nn._pack_ref4(r.to(dev))


@pytest.mark.parametrize("split", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("M,N", [(2_867, 6_438), (211_176, 11_155), (3_001, 3 * 8 * 512 + 77), (5_003, 40_011)])
def test_k3_at_occupancy_and_ragged_shapes_every_split(cuda, M, N, split):
    """K3 at the mobile occupancy builds' shapes (shared queries, one
    set), at a ragged N and at a large one (shares of many chunks through
    the ring, rescans from global memory), at the plan and at each forced
    S: against plain, one launch each."""
    q, r4 = _occupancy_like(cuda, M, N)
    before = nn.min_sqdist_launches
    got = nn.nearest_batched(q, r4, split=split)
    torch.cuda.synchronize()
    assert nn.min_sqdist_launches == before + 1
    _check_nearest(q, r4, None, got, nn.nearest_batched_reference(q, r4))


@pytest.mark.parametrize("C,M,N,shared", [(1, 2_867, 6_438, True), (3, 5_003, 4_096, False), (2, 777, 1_000, False)])
def test_nearest_every_split_gives_the_same_bits(cuda, C, M, N, shared):
    """d2, index, point and normal are the plan's bits at every forced
    cluster size, 16 included where the card admits it."""
    q, r4, nrm = _nearest_inputs(cuda, C, M, N, seed=9, n_pad=N // 10)
    if shared:
        q = q[0].contiguous()
    planned = nn.nearest_batched(q, r4, nrm)
    splits = [1, 2, 4, 8] + ([16] if nn._k2_card(q.device)[2] == 16 else [])
    for split in splits:
        got = nn.nearest_batched(q, r4, nrm, split=split)
        for a, b in zip(got, planned):
            assert torch.equal(a, b), split


def test_nearest_all_pad_set_takes_the_first_row(cuda):
    q, r4, nrm = _nearest_inputs(cuda, 2, 3_000, 2_100, n_pad=100)
    r4[1, :, :3] = PAD_COORD  # set 1: every row padding, all exactly tied
    got = nn.nearest_batched(q, r4, nrm)
    want = nn.nearest_batched_reference(q, r4, nrm)
    torch.cuda.synchronize()
    _check_nearest(q, r4, nrm, got, want)
    assert bool((got[1][1] == 0).all()) and bool(torch.isfinite(got[0][1]).all())


def test_min_sqdist_mask_and_all_invalid_set(cuda):
    q, r4, _ = _nearest_inputs(cuda, 4, 5_000, 3_000, valid=0.6)
    r4[2, :, 3] = nn.PENALTY_BIG  # set 2: every point invalid
    want = nn.nearest_batched_reference(q, r4)
    for split in (None, 1, 4, 8):
        got = nn.nearest_batched(q, r4, split=split)
        torch.cuda.synchronize()
        _check_nearest(q, r4, None, got, want)
        assert bool((got[0][2] >= 1e38).all()) and bool((got[1][2] == 0).all())
        valid = r4[..., 3] == 0
        assert bool(torch.gather(valid[[0, 1, 3]], 1, got[1][[0, 1, 3]].long()).all())


def test_nearest_duplicates_first_index_wins(cuda):
    """F1: of two coincident points (3,000 rows apart, in different
    chunks) the kernel returns the first."""
    g = torch.Generator().manual_seed(3)
    base = torch.rand((2, 3_000, 3), generator=g)
    ref = torch.cat([base, base], dim=1).to(cuda)
    nrm = torch.cat([torch.tensor([0.0, 0.0, 1.0]).expand(2, 3_000, 3),
                     torch.tensor([0.0, 0.0, -1.0]).expand(2, 3_000, 3)], dim=1).contiguous().to(cuda)
    q = torch.cat([base + 1e-3, torch.rand((2, 1_000, 3), generator=g)], dim=1).to(cuda)
    d2, pt, nm = nn.nearest_point_normal(q, ref, nrm)
    _, idx = nn.min_sqdist(q, ref)
    torch.cuda.synchronize()
    assert bool((idx < 3_000).all()) and bool((nm[..., 2] == 1.0).all())
    assert torch.equal(pt, torch.gather(ref, 1, idx.long()[..., None].expand(-1, -1, 3)))


@pytest.mark.parametrize("split", [2, 4, 8])
def test_nearest_duplicates_across_a_share_boundary(cuda, split):
    """Exact duplicates on both sides of every share boundary of a forced
    split (row b, a share's first, repeats row b - 3 of the share before),
    within one sub-tile (b + 5 repeats b + 1) and across a sub-tile
    boundary (b + 33 repeats b + 30): the lower index wins each time."""
    N = 4_096
    g = torch.Generator().manual_seed(split)
    r = torch.rand((1, N, 3), generator=g)
    bounds = [s1 for _, s1 in nn._shares(N, split)[:-1]]
    first = []
    for b in bounds:
        for lo, hi in ((b - 3, b), (b + 1, b + 5), (b + 30, b + 33)):
            r[0, hi] = r[0, lo]
            first.append(lo)
    q = torch.cat([r[0, first] + 1e-4, torch.rand((500, 3), generator=g)]).to(cuda)
    r4 = nn._pack_ref4(r.to(cuda))
    want = nn.nearest_batched_reference(q, r4)
    got = nn.nearest_batched(q, r4, split=split)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert got[1][0, : len(first)].tolist() == first  # one set, shared queries


def test_nearest_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, r4, nrm = _nearest_inputs(cuda, 2, 100, 100)
    counts = (nn.nearest_launches, nn.min_sqdist_launches)
    with pytest.raises(TypeError):
        nn.nearest_batched(q.double(), r4.double(), nrm.double())
    with pytest.raises(ValueError):
        nn.nearest_batched(q.cpu(), r4, nrm)
    with pytest.raises(ValueError):
        nn.nearest_batched(q, r4, nrm.cpu())
    with pytest.raises(ValueError):
        nn.nearest_batched(q[:, ::2], r4)  # not contiguous
    with pytest.raises(ValueError):  # (C, 4, N): the old transposed layout
        nn.nearest_batched(q, r4.transpose(1, 2).contiguous())
    with pytest.raises(ValueError):  # 4 bytes past an aligned address
        nn.nearest_batched(q, r4.reshape(-1)[1 : 1 + 2 * 99 * 4].view(2, 99, 4))
    with pytest.raises(ValueError):
        nn.nearest_batched(q, r4, split=3)
    assert (nn.nearest_launches, nn.min_sqdist_launches) == counts


@pytest.mark.parametrize("plan", [(512, 32), (2048, 1)])
def test_nearest_refused_launch_raises(cuda, monkeypatch, plan):
    """A geometry the kernel or the card refuses (a cluster beyond 16, a
    block beyond the launch bounds) raises with the plan in the message;
    the wrapper never hands back another path's output."""
    q, r4, nrm = _nearest_inputs(cuda, 1, 5_000, 8_192)
    monkeypatch.setattr(nn, "_k2_launch_plan", lambda *a, **k: plan)
    counts = (nn.nearest_launches, nn.min_sqdist_launches)
    with pytest.raises(RuntimeError, match=f"K2 launch \\(tile_m {plan[0]}, split {plan[1]}\\)"):
        nn.nearest_batched(q, r4, nrm)
    assert (nn.nearest_launches, nn.min_sqdist_launches) == counts
    monkeypatch.undo()
    torch.cuda.synchronize()  # the refusal left no error behind
    _check_nearest(q, r4, nrm, nn.nearest_batched(q, r4, nrm), nn.nearest_batched_reference(q, r4, nrm))


# -- K4: the packed-row field lookup ------------------------------------------

K4_ORIGIN = (-0.4, -1.5, -0.4)
K4_SHAPE = (38, 60, 42)  # the synthetic arm's 95,760-cell grid
K4_RES = 0.05


def _lookup_inputs(dev, lead, n_tables=1, seed=0):
    """A stacked table of n_tables field pairs, (R, 8) float32 on `dev`,
    and points (*lead, 3) over the grid and 0.1 m beyond it, a fifth of
    their coordinates exactly on cell faces."""
    from grasptrajopt_tpu_torch.ops import interp

    g = torch.Generator(device="cpu").manual_seed(seed)
    S = K4_SHAPE[0] * K4_SHAPE[1] * K4_SHAPE[2]
    fields = torch.rand((2 * n_tables, S), generator=g) * 0.1
    table = interp.pack_corners(fields, K4_SHAPE).reshape(-1, 8)
    origin, shape = torch.tensor(K4_ORIGIN), torch.tensor(K4_SHAPE)
    lo, hi = origin - 0.1, origin + (shape - 1) * K4_RES + 0.1
    pts = lo + torch.rand(lead + (3,), generator=g) * (hi - lo)
    face = origin + torch.floor(torch.rand(lead + (3,), generator=g) * shape) * K4_RES
    pts = torch.where(torch.rand(lead + (3,), generator=g) < 0.2, face, pts)
    return table.to(dev), pts.to(dev), S


def _check_lookup(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert bool(((a - b).abs() <= TOL * (1 + b.abs())).all())


@pytest.mark.parametrize(
    "lead,layout",
    [
        ((32, 50, 1_000), "shared"),  # the bench's fine pass
        ((16, 50, 100), "stacked"),  # per-problem tables, 16 objects
        ((3, 7, 11), "per_point"),  # ragged: not a multiple of the block
        ((4, 50, 123), "aos"),  # the x / y / z views of (..., 3) points
    ],
)
def test_field_lookup_kernel_matches_plain(cuda, lead, layout):
    from grasptrajopt_tpu_torch.ops import interp

    n_tables = 16 if layout == "stacked" else 1
    table, pts, S = _lookup_inputs(cuda, lead, n_tables)
    T = lead[1]
    phase = (torch.arange(T, device=cuda) >= T - 10).long()[:, None] * S  # (T, 1)
    if layout == "stacked":
        row = phase + (torch.arange(lead[0], device=cuda) * 2 * S)[:, None, None]
    elif layout == "per_point":
        row = torch.randint(0, 2, lead, device=cuda) * S
    else:
        row = phase
    if layout == "aos":
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    else:
        x, y, z = (pts[..., i].contiguous() for i in range(3))
    before = interp.field_lookup_launches
    got = interp.field_lookup_packed_soa_grad(table, x, y, z, K4_ORIGIN, K4_SHAPE, K4_RES, row_offset=row)
    torch.cuda.synchronize()
    assert interp.field_lookup_launches == before + 1
    want = interp.field_lookup_packed_soa_grad_reference(table, x, y, z, K4_ORIGIN, K4_SHAPE, K4_RES, row_offset=row)
    _check_lookup(got, want)


def test_field_lookup_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from grasptrajopt_tpu_torch.ops import interp

    table, pts, _ = _lookup_inputs(cuda, (2, 5, 7))
    x, y, z = (pts[..., i].contiguous() for i in range(3))
    before = interp.field_lookup_launches
    with pytest.raises(TypeError):  # float64 on the card
        interp.field_lookup_packed_soa_grad(table.double(), x.double(), y.double(), z.double(),
                                            K4_ORIGIN, K4_SHAPE, K4_RES)
    with pytest.raises(ValueError):  # the table on the CPU
        interp.field_lookup_packed_soa_grad(table.cpu(), x, y, z, K4_ORIGIN, K4_SHAPE, K4_RES)
    with pytest.raises(ValueError):  # no common stride between the points
        interp.field_lookup_packed_soa_grad(table, x[:, :, ::2], y[:, :, ::2], z[:, :, ::2].contiguous(),
                                            K4_ORIGIN, K4_SHAPE, K4_RES)
    with pytest.raises(ValueError):  # a float row offset
        interp.field_lookup_packed_soa_grad(table, x, y, z, K4_ORIGIN, K4_SHAPE, K4_RES,
                                            row_offset=torch.zeros((2, 5, 1), device=cuda))
    assert interp.field_lookup_launches == before


@pytest.mark.parametrize(
    "lead,layout",
    [
        ((32, 50, 1_000), "shared"),  # the bench's fine pass
        ((16, 50, 100), "stacked"),  # per-problem tables, 16 objects
        ((4, 50, 123), "aos"),  # the x / y / z views of (..., 3) points
        ((3, 7, 11), "ragged"),
    ],
)
def test_field_lookup_bf16_mode_matches_plain(cuda, lead, layout):
    """The bf16-row mode: the same lookups on the table cast to bf16, one
    launch each, within the float32 mode's tolerance of the plain version
    (which upcasts the same rows)."""
    from grasptrajopt_tpu_torch.ops import interp

    n_tables = 16 if layout == "stacked" else 1
    table, pts, S = _lookup_inputs(cuda, lead, n_tables, seed=1)
    table = table.to(torch.bfloat16)
    T = lead[1]
    row = (torch.arange(T, device=cuda) >= T - 3).long()[:, None] * S
    if layout == "stacked":
        row = row + (torch.arange(lead[0], device=cuda) * 2 * S)[:, None, None]
    if layout == "aos":
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    else:
        x, y, z = (pts[..., i].contiguous() for i in range(3))
    before = interp.field_lookup_launches
    got = interp.field_lookup_packed_soa_grad(table, x, y, z, K4_ORIGIN, K4_SHAPE, K4_RES, row_offset=row)
    torch.cuda.synchronize()
    assert interp.field_lookup_launches == before + 1
    want = interp.field_lookup_packed_soa_grad_reference(table, x, y, z, K4_ORIGIN, K4_SHAPE, K4_RES, row_offset=row)
    _check_lookup(got, want)


def test_field_lookup_bf16_wrapper_refuses(cuda):
    """float16 tables and a bf16 table off 16-byte alignment raise."""
    from grasptrajopt_tpu_torch.ops import interp

    table, pts, _ = _lookup_inputs(cuda, (2, 5, 7))
    x, y, z = (pts[..., i].contiguous() for i in range(3))
    flat = torch.empty(table.numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view(table.shape)  # 2 bytes off the allocation's alignment
    shifted.copy_(table)
    before = interp.field_lookup_launches
    with pytest.raises(TypeError):
        interp.field_lookup_packed_soa_grad(table.half(), x, y, z, K4_ORIGIN, K4_SHAPE, K4_RES)
    with pytest.raises(ValueError):
        interp.field_lookup_packed_soa_grad(shifted, x, y, z, K4_ORIGIN, K4_SHAPE, K4_RES)
    assert interp.field_lookup_launches == before


@pytest.mark.parametrize("interp_mode,launches", [("trilinear", 1 + 2 * 3), ("nearest", 0)])
def test_ik_collision_term_launches(cuda, interp_mode, launches):
    """The IK screen's collision term on the card: with trilinear lookups
    K4 launches exactly once for the starting cost and twice an LM
    iteration (the linearisation and the trial candidates), for the whole
    multistart batch; the nearest variant is a plain gather."""
    from grasptrajopt_tpu_torch.ops import interp
    from grasptrajopt_tpu_torch.planning import ik_solver
    from grasptrajopt_tpu_torch.testing import SYNTH_DEFAULT_POSE, make_synthetic_goal, make_synthetic_gto_robot

    robot = make_synthetic_gto_robot(device=cuda, dtype=torch.float32, points_per_link=100)
    z = torch.as_tensor(robot.grid.grid_points(np.float32)[:, 2], device=cuda)
    field = torch.clamp(0.6 - z, min=0.0)
    goals = torch.as_tensor(np.stack([make_synthetic_goal(s) for s in range(4)]), dtype=torch.float32, device=cuda)
    qc = torch.as_tensor(SYNTH_DEFAULT_POSE, dtype=torch.float32, device=cuda)
    ik = ik_solver.IKSolver(robot, "hand", "hand", interp=interp_mode, iterations=3, num_seeds=2)
    before = interp.field_lookup_launches
    q, _, _, col = ik.solve_ik_batch(qc, goals, field, (0.01, -0.02, 0.03), multistart=True)
    torch.cuda.synchronize()
    assert interp.field_lookup_launches == before + launches
    assert bool(torch.isfinite(q).all()) and bool(torch.isfinite(col).all())


# -- the closed-loop pipeline's clouds, replay scorer and one trial ----------


def _observation(width=160):
    """Tabletop scene 10 at width x width: (depth, target mask of the
    nearest object, camera pose, K, env, object name)."""
    from grasptrajopt_tpu_torch.envs.synthetic import SyntheticSceneEnv

    env = SyntheticSceneEnv(robot_name="panda", scene_type="tabletop", n_objects=5, width=width, height=width)
    meta = env.setup_scene(10)
    env.reset_scene()
    name = meta["nearest_first"].split(",")[0]
    depth, ids, cam_pose, K = env.get_observation()
    return depth, ids == env._placed(name).uid, cam_pose, K, env, name


def _cloud_plain_sdf(cloud, q):
    """The signed distances of the cloud's queries from K1's plain version."""
    r4 = nn._pack_ref4(cloud.points_padded[None], cloud.valid[None])
    d = torch.sqrt(nn.min_d2_batched_reference(q.contiguous(), r4)[0])
    return torch.where(cloud.is_outside(q), d, -d)


def test_depth_cloud_sdf_and_cost_field_match_plain(cuda):
    """DepthPointCloud.get_sdf (obstacle view: the target masked out) and
    build_cost_field: one K1 launch each, squared distances within TOL of
    the plain version's and identical signs; the cost field within TOL."""
    from grasptrajopt_tpu_torch.fields.depth_point_cloud import DepthPointCloud, sdf_cost_shaping
    from grasptrajopt_tpu_torch.testing import make_synthetic_gto_robot

    depth, mask, pose, K, _, _ = _observation()
    d_obs = depth.copy()
    d_obs[mask] = 1.5
    cloud = DepthPointCloud(d_obs, K, pose, mask, device=cuda)
    g = torch.Generator().manual_seed(7)
    q = (torch.rand((50_000, 3), generator=g) * torch.tensor([1.2, 1.6, 1.2]) + torch.tensor([0.0, -0.8, 0.0])).to(cuda)
    before = nn.min_d2_launches
    got = cloud.get_sdf(q)
    torch.cuda.synchronize()
    assert nn.min_d2_launches == before + 1
    want = _cloud_plain_sdf(cloud, q)
    assert float((got.double() ** 2 - want.double() ** 2).abs().max()) <= TOL
    assert torch.equal(got < 0, want < 0) and bool((got < 0).any())

    grid = make_synthetic_gto_robot(device=cuda, points_per_link=1).grid
    field = cloud.build_cost_field(grid)
    torch.cuda.synchronize()
    assert nn.min_d2_launches == before + 2 and field.shape == (grid.size,)
    gp = torch.as_tensor(grid.grid_points(), device=cuda)
    assert float((field - sdf_cost_shaping(_cloud_plain_sdf(cloud, gp))).abs().max()) <= TOL


def test_score_plans_pergoal_cuda_matches_cpu(cuda):
    """The replay scorer on the card (one K1 launch for the batch) against
    the same float32 replay on the CPU: collision and reach verdicts
    identical, inside counts within one point, errors within 1e-4."""
    from grasptrajopt_tpu_torch.fields.depth_point_cloud import DepthPointCloud
    from grasptrajopt_tpu_torch.planning.evaluate import score_plans_pergoal
    from grasptrajopt_tpu_torch.testing import SYNTH_DEFAULT_POSE, make_synthetic_gto_robot

    depth, mask, pose, K, env, name = _observation()
    d_obs = depth.copy()
    d_obs[mask] = 1.5
    RT = env.grasps_world(name)[:6].copy()
    RT[:, :3, 3] -= env.base_position
    # plans that swing the shoulder forward by 0.2-1.2 rad: some reach
    # into the table
    T = 50
    s = np.linspace(0.0, 1.0, T)
    plans = np.tile(SYNTH_DEFAULT_POSE[None, :, None], (6, 1, T))
    plans[:, 1] += np.linspace(0.2, 1.2, 6)[:, None] * s
    plans[:, 3] += 0.5 * s
    out = {}
    for dev in (cuda, torch.device("cpu")):
        robot = make_synthetic_gto_robot(device=dev, points_per_link=100)
        cloud = DepthPointCloud(d_obs, K, pose, mask, device=dev)
        before = nn.min_d2_launches
        out[dev.type] = score_plans_pergoal(robot, "hand", plans, RT, cloud, env.base_position)
        if dev.type == "cuda":
            assert nn.min_d2_launches == before + 1
    a, b = out["cuda"], out["cpu"]
    assert any(r["collision"] for r in b) and not all(r["collision"] for r in b)
    for x, y in zip(a, b):
        assert (x["collision"], x["reached"], x["reward"]) == (y["collision"], y["reached"], y["reward"])
        assert abs(x["max_inside_points"] - y["max_inside_points"]) <= 1
        assert abs(x["err_pos"] - y["err_pos"]) <= 1e-4 and abs(x["err_rot"] - y["err_rot"]) <= 1e-2


def test_synth7_tabletop_trial_on_the_card(cuda, tmp_path):
    """One closed-loop trial (tabletop scene 10, its nearest object) at
    full width through the harness, on the models build_models gives with
    its defaults: a finite plan within the limits,
    pinned at the start for its first two steps, scored."""
    from grasptrajopt_tpu_torch import synthetic_eval as se
    from grasptrajopt_tpu_torch.testing import SYNTH_EVAL_CONFIG

    robot, gripper, cfg = se.build_models("synth7")  # the defaults: the card, float32
    assert robot.device.type == "cuda" and robot.dtype == gripper.dtype == torch.float32
    res = se.evaluate_scenes(
        robot, gripper, cfg, scene_ids=[10], n_objects=1, orderings=["nearest_first"],
        iterations=3, single_pass=True, coarse_iterations=2, final_trust=True, verbose=False,
        checkpoint_path=str(tmp_path / "result.json"),
    )
    (rec,) = res["10"]["nearest_first"].values()
    assert rec["stage"] == "ok" and "collision" in rec
    plan = np.asarray(rec["plan"])  # (ndof, T)
    assert plan.shape == (robot.ndof, 50) and np.isfinite(plan).all()
    qc = np.asarray(SYNTH_EVAL_CONFIG["default_pose"], np.float32)
    np.testing.assert_array_equal(plan[:, :2], np.stack([qc, qc], axis=1))
    opt = robot.optimized_joint_indexes
    assert (plan[opt] >= robot.lower_optimized_joint_limits[:, None] - 1e-6).all()
    assert (plan[opt] <= robot.upper_optimized_joint_limits[:, None] + 1e-6).all()
    assert se.summary(res)["trials"] == 1


def _mobile_view(scene_type, size=160):
    """The mobile harness's view from its parked base (-0.8, 0.3, yaw
    -0.3) on synth7's mount: every valid point in that base frame (the
    occupancy build's input), host float32 (N, 3)."""
    from grasptrajopt_tpu_torch import synthetic_eval_mobile as mobile
    from grasptrajopt_tpu_torch.envs.synthetic import SyntheticSceneEnv
    from grasptrajopt_tpu_torch.fields.depth_point_cloud import DepthPointCloud

    env = SyntheticSceneEnv(robot_name="panda", scene_type=scene_type, n_objects=5, width=size, height=size)
    env.setup_scene(10)
    env.reset_scene()
    RT_base = mobile.base_pose_matrix(-0.8, 0.3, -0.3)
    RT_base[2, 3] = env.base_position[2]
    target = env.TABLE_POS + [0.0, 0.0, env.TABLE_HEIGHT] if scene_type == "tabletop" else env.SHELF_POS
    depth, _, cam_w, K = env.get_observation(mobile.head_camera_pose(RT_base, target))
    return DepthPointCloud(depth, K, np.linalg.inv(RT_base) @ cam_w, threshold=np.inf, device="cpu").points


@pytest.mark.parametrize("scene_type,resolution", [("tabletop", 0.05), ("shelf", 0.025)])
def test_occupancy_build_matches_plain(cuda, scene_type, resolution):
    """setup_occupancy_grid at the mobile harness's full-width shapes (a
    few thousand cells on the tabletop, ~2e5 on the shelf, where far
    background points widen the grid): one K3 launch, the grid identical
    cell for cell to the plain version's on the same CUDA tensors."""
    from grasptrajopt_tpu_torch.testing import make_synthetic_gto_robot

    pts = _mobile_view(scene_type)
    robot = make_synthetic_gto_robot(device=cuda, points_per_link=1, grid_resolution=resolution)
    before = nn.min_sqdist_launches
    grid = robot.setup_occupancy_grid(pts)
    torch.cuda.synchronize()
    assert nn.min_sqdist_launches == before + 1
    xy = pts[pts[:, 2] > 0.01][:, :2]
    gp = grid.grid_points()
    q = torch.as_tensor(np.concatenate([gp, np.zeros((gp.shape[0], 1), np.float32)], axis=1), device=cuda)
    r = torch.as_tensor(np.concatenate([xy, np.zeros((xy.shape[0], 1))], axis=1), dtype=torch.float32, device=cuda)
    d2_kernel, _ = nn.min_sqdist(q, r)
    d2_plain, _ = nn.min_sqdist_reference(q, r)
    assert float((d2_kernel - d2_plain).abs().max()) <= TOL
    want = (torch.sqrt(d2_plain) < 0.02).float()
    assert robot.occupancy_grid.shape == (grid.size,) and torch.equal(robot.occupancy_grid, want)
    assert 0 < float(want.sum()) < grid.size


def test_base_solve_on_the_card_matches_cpu(cuda):
    """BasePlanner on the card (float32) against the CPU's float64 on the
    out-of-reach scenario (the default hand pose pushed 0.8 m along +x),
    both run to convergence (200 LM iterations): the base pose within
    1e-3 m and 1e-3 rad, the goal reached. At the planner's default 100
    iterations neither precision has converged along the valley that the
    weak base-effort term leaves (float64 moves 3e-4 m more by 200,
    float32 on the CPU 4e-3 m)."""
    from grasptrajopt_tpu_torch.planning import BasePlanner
    from grasptrajopt_tpu_torch.testing import SYNTH_DEFAULT_POSE, make_synthetic_gto_robot

    out = {}
    for dev, dtype in ((cuda, torch.float32), (torch.device("cpu"), torch.float64)):
        robot = make_synthetic_gto_robot(device=dev, dtype=dtype, points_per_link=10)
        RT = robot.get_global_link_transform("hand", torch.as_tensor(SYNTH_DEFAULT_POSE, dtype=dtype, device=dev))
        RT = RT.double().cpu().numpy()
        RT[0, 3] += 0.8
        planner = BasePlanner(robot, "hand", "hand", iterations=200)
        out[dev.type] = planner.plan_goalset(SYNTH_DEFAULT_POSE, RT[None], verbose=False)
    (Q, y, err_pos, err_rot, col), (_, y64, _, _, _) = out["cuda"], out["cpu"]
    assert np.isfinite(Q).all() and y.dtype == np.float64
    np.testing.assert_allclose(y[:2], y64[:2], atol=1e-3, rtol=0)
    assert abs(y[2] - y64[2]) <= 1e-3 and -np.pi <= y[2] <= np.pi
    assert y[0] < -0.2 and err_pos[0] < 0.05 and err_rot[0] < 10.0 and col == 0.0


# -- the builder stack on the card (small sizes), against the CPU ---------


def _toy_nlps():
    """(f, h, g, x0, config) of the AL-SQP toy problems."""
    from grasptrajopt_tpu_torch.opt import ALSQPConfig

    return {
        "equality": (lambda x, p: torch.sum(x * x), lambda x, p: torch.stack([x[0] + x[1] - 1.0]), None,
                     np.zeros(2), ALSQPConfig()),
        "inequality": (lambda x, p: torch.sum((x - 2.0) ** 2), None, lambda x, p: 1.0 - x,
                       np.zeros(1), ALSQPConfig()),
        "sin_nlp": (lambda x, p: torch.sum(torch.sin(x)) + torch.sum(x * x), None,
                    lambda x, p: torch.stack([2.0 - torch.sum(x * x)]), np.full(3, 0.5),
                    ALSQPConfig(outer_iterations=12, inner_iterations=25)),
    }


@pytest.mark.parametrize("case", ["equality", "inequality", "sin_nlp"])
def test_al_sqp_toy_nlps_on_the_card_match_cpu(cuda, case):
    from grasptrajopt_tpu_torch.opt import make_al_sqp_solver

    f, h, g, x0, cfg = _toy_nlps()[case]
    solve = make_al_sqp_solver(f, h, g, cfg)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        n = x0.shape[0]
        x, info = solve(torch.as_tensor(x0, dtype=torch.float64, device=dev),
                        torch.full((n,), -np.inf, dtype=torch.float64, device=dev),
                        torch.full((n,), np.inf, dtype=torch.float64, device=dev), None)
        assert x.device.type == dev.type
        out[dev.type] = (x.cpu().numpy(), float(info["constraint_violation"]))
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=1e-10)
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-10
    if case == "equality":
        np.testing.assert_allclose(out["cuda"][0], [0.5, 0.5], atol=1e-6)


def test_admm_batched_on_the_card_matches_cpu(cuda):
    from grasptrajopt_tpu_torch.opt import solve_qp_admm

    gen = torch.Generator().manual_seed(2)
    B, n, m = 8, 40, 6
    M = torch.randn((B, n, n), generator=gen, dtype=torch.float64) / n**0.5
    P = M @ M.mT + torch.eye(n, dtype=torch.float64)
    q = torch.randn((B, n), generator=gen, dtype=torch.float64)
    A = torch.randn((B, m, n), generator=gen, dtype=torch.float64) / n**0.5
    b = torch.randn((B, m), generator=gen, dtype=torch.float64)
    x_cpu = solve_qp_admm(P, q, A, b, b)[0]
    x_gpu = solve_qp_admm(*(t.to(cuda) for t in (P, q, A, b, b)))[0]
    np.testing.assert_allclose(x_gpu.cpu().numpy(), x_cpu.numpy(), atol=1e-9)
    kkt = torch.cat([torch.cat([P, A.mT], dim=2), torch.cat([A, torch.zeros((B, m, m), dtype=torch.float64)], dim=2)],
                    dim=1)
    want = torch.linalg.solve(kkt.to(cuda), torch.cat([-q, b], dim=1).to(cuda))[:, :n]
    assert float((x_gpu - want).abs().max()) <= 1e-4


def test_rnea_on_the_card_matches_cpu(cuda):
    from grasptrajopt_tpu_torch.models import RobotModel
    from grasptrajopt_tpu_torch.models.dynamics import coriolis_vector, gravity_vector, mass_matrix
    from grasptrajopt_tpu_torch.testing import DOUBLE_PENDULUM_URDF

    rng = np.random.default_rng(3)
    robots = {d.type: RobotModel(urdf_string=DOUBLE_PENDULUM_URDF, dtype=torch.float64, device=d)
              for d in (cuda, torch.device("cpu"))}
    for _ in range(3):
        q, qd, qdd = (rng.uniform(-1.5, 1.5, size=2) for _ in range(3))
        out = {}
        for k, r in robots.items():
            t = [torch.as_tensor(v, dtype=torch.float64, device=r.device) for v in (q, qd, qdd)]
            tau = r.rnea(*t)
            split = mass_matrix(r, t[0]) @ t[2] + coriolis_vector(r, t[0], t[1]) + gravity_vector(r, t[0])
            assert float((tau - split).abs().max()) <= 1e-10
            out[k] = tau.cpu().numpy()
        np.testing.assert_allclose(out["cuda"], out["cpu"], atol=1e-10)


def test_sdf_program_matches_k4_on_the_card(cuda):
    from grasptrajopt_tpu_torch.fields import sdf_value_jac_hess
    from grasptrajopt_tpu_torch.ops import interp
    from grasptrajopt_tpu_torch.testing import make_synthetic_gto_robot, make_synthetic_scene_field

    robot = make_synthetic_gto_robot(device=cuda, points_per_link=1)
    g = robot.grid
    field = torch.as_tensor(make_synthetic_scene_field(robot), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    lo = torch.tensor([0.25, -0.35, 0.30], device=cuda)
    pts = lo + torch.rand((4096, 3), generator=gen, device=cuda) * torch.tensor([0.7, 0.7, 0.2], device=cuda)
    vals, jac, hess = sdf_value_jac_hess(g, field, pts)
    before = interp.field_lookup_launches
    k4 = interp.field_lookup_packed_soa_grad(g.pack(field), pts[:, 0], pts[:, 1], pts[:, 2], g.origin, g.shape,
                                             g.resolution)
    assert interp.field_lookup_launches == before + 1
    for got, want in zip(k4, (vals, jac[:, 0], jac[:, 1], jac[:, 2])):
        assert float((got - want).abs().max()) <= 1e-5 * (1 + float(want.abs().max()))
    assert float(jac.abs().max()) > 0.1
    assert bool((torch.diagonal(hess, dim1=1, dim2=2) == 0).all())
    # against the CPU's float64 program at the same points: float32
    # rounding, relative to each output's largest entry (the mixed second
    # derivatives reach ~(field step) / resolution^2 ~ 20)
    cpu = sdf_value_jac_hess(g, field.double().cpu(), pts.double().cpu())
    for got, want in zip((vals, jac, hess), cpu):
        err = float((got.double().cpu() - want).abs().max())
        assert err <= 1e-5 * (1 + float(want.abs().max())), err


def test_plan_stream_on_the_card_is_the_synchronous_loop(cuda):
    """The serving demo's stream at depths 1, 2 and 4 against its
    synchronous loop on the card: plans and costs bit for bit, and K4
    launched 1 + 2 x iterations times a solve (the two-pass LM)."""
    from grasptrajopt_tpu_torch import throughput_serving as serving
    from grasptrajopt_tpu_torch.ops import interp

    server = serving.Server(iterations=3, goals=2, device=cuda, points_per_link=8)
    requests = [server.request(seed, 4) for seed in range(4)]
    before = interp.field_lookup_launches
    server.solve(*requests[0])
    torch.cuda.synchronize()
    assert interp.field_lookup_launches == before + 1 + 2 * 3
    for depth in (1, 2, 4):
        out = serving.serve(server, requests, depth)
        for (Qs, cs), (Qp, cp) in zip(out["sync"], out["pipelined"]):
            assert torch.equal(Qs, Qp) and torch.equal(cs, cp)
            assert bool(torch.isfinite(Qs).all())


def test_phase_timer_sync_waits_for_the_card(cuda):
    from grasptrajopt_tpu_torch.utils.profiling import PhaseTimer, device_memory_stats

    waits, lazy = PhaseTimer(sync=True, device=cuda), PhaseTimer(sync=False)
    for timer in (lazy, waits):
        with timer.phase("sleep"):
            torch.cuda._sleep(200_000_000)  # ~0.1 s of the card's clock
    torch.cuda.synchronize()
    assert waits.totals["sleep"] > 0.05 > lazy.totals["sleep"]
    assert "allocated_bytes.all.current" in device_memory_stats(cuda)


def _small_bench(cuda, **kw):
    from grasptrajopt_tpu_torch import bench as pb
    from grasptrajopt_tpu_torch.testing import make_synthetic_gto_robot

    robot = make_synthetic_gto_robot(device=cuda, dtype=torch.float32, points_per_link=8)
    return pb, robot, pb.SolveBenchConfig(batch=4, goal_capacity=2, T=12, **kw)


@pytest.mark.parametrize("flavour", ["default", "two_pass"])
def test_bench_and_served_solves_make_no_host_sync(cuda, flavour):
    """A bench solve and a served solve enqueue all their work without
    waiting on the card (set_sync_debug_mode("error") raises at a sync)."""
    from grasptrajopt_tpu_torch import throughput_serving as serving

    pb, robot, cfg = _small_bench(cuda, **({} if flavour == "default" else dict(
        single_pass=False, coarse_iterations=0, final_trust=False)))
    bench = pb.SolveBench(robot, cfg)
    server = serving.Server(iterations=2, goals=2, device=cuda, points_per_link=8)
    request = server.request(0, 4)
    bench.step(), server.solve(*request)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        Q, _, _ = bench.step()
        Qs, _, _ = server.solve(*request)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(Q).all()) and bool(torch.isfinite(Qs).all())


def test_recorded_spans_add_no_host_sync(cuda):
    """Under torch.profiler a bench solve and a served solve record their
    spans on the card; the recorder's anchor is no sync of the solves'
    (an enclosing count_syncs sees none, nor does each `solve` span), while
    an `.item()` is seen; each reading's spans get stream intervals inside
    their solve's, and the next reading takes a new anchor."""
    from torch.profiler import ProfilerActivity, profile

    from grasptrajopt_tpu_torch import throughput_serving as serving
    from grasptrajopt_tpu_torch.utils import profiling

    pb, robot, cfg = _small_bench(cuda)
    bench = pb.SolveBench(robot, cfg)
    server = serving.Server(iterations=2, goals=2, device=cuda, points_per_link=8)
    request = server.request(0, 4)
    bench.step(), server.solve(*request)
    with profiling.count_syncs() as sites:
        torch.ones(1, device=cuda).item()
    assert sum(sites.values()) == 1
    profiling.resolved_spans()
    anchors = set()
    for _ in range(2):
        before = len(profiling.recorder.ring)
        with profile(activities=[ProfilerActivity.CUDA]):
            with profiling.count_syncs() as outer:
                bench.step(), server.solve(*request)
        torch.cuda.synchronize()
        n = len(profiling.recorder.ring) - before
        anchors |= {id(s.anchor[1]) for s in list(profiling.recorder.ring)[-n:]}
        spans = [s for s in profiling.resolved_spans()[-n:] if s.solve is not None]
        assert outer == {}
        solves = [s for s in spans if s.name == "solve"]
        assert len(solves) == 2 and [s.syncs for s in solves] == [0, 0]
        for s in spans:
            (top,) = [p for p in solves if p.solve == s.solve]
            assert top.stream[0] <= s.stream[0] <= s.stream[1] <= top.stream[1]
    assert len(anchors) == 2


def test_sharded_step_at_a_world_of_one_is_the_unsharded_solve(cuda, tmp_path, monkeypatch):
    """bench.py's mesh mode on NCCL at a world of one: the step's plans and
    costs bit for bit the unsharded stacked solve's, its mean cost
    cost.mean() within 1e-6 relative, K4 3 launches a step."""
    import torch.distributed as dist

    from grasptrajopt_tpu_torch import parallel
    from grasptrajopt_tpu_torch.ops import interp
    from grasptrajopt_tpu_torch.parallel import mesh as port_mesh

    for k in port_mesh.CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    pb, robot, cfg = _small_bench(cuda)
    assert parallel.distributed_init(coordinator=f"file://{tmp_path}/store", device=cuda)
    try:
        assert dist.get_backend() == "nccl"
        bench = pb.ShardedSolveBench(robot, cfg, parallel.data_mesh(1))
        bench.step()
        before = interp.field_lookup_launches
        Q, cost, _ = bench.step()
        torch.cuda.synchronize()
        assert interp.field_lookup_launches == before + 3
        fields = bench.field.expand(cfg.batch, -1)
        Q_ref, cost_ref, _ = bench.solve_shard(bench.qc_opt, bench.X0, bench.params, fields, fields)
        mean_cost = float(bench.metrics["mean_cost"])
    finally:
        dist.destroy_process_group()
    assert torch.equal(Q, Q_ref) and torch.equal(cost, cost_ref)
    assert mean_cost == pytest.approx(float(cost_ref.mean()), rel=1e-6)


def test_scenereplica_driver_on_the_card(cuda, tmp_path, monkeypatch):
    """The port's gto_planning and evaluate_plans on the card at small
    width over a synth7 tree (4 grasps an object, synth7 at 10 points a
    link, a 96x72 window, 3 two-pass planner iterations, 10 IK
    iterations, the simulator's waits skipped) on the port's fake
    PyBullet: the JAX result schema, both objects planned in both
    orderings, K1 3 launches an object and K4 7 a plan, then 1 K1 launch
    a replayed plan."""
    import importlib
    import json
    import sys
    import time
    import types

    from grasptrajopt_tpu_torch import evaluate_plans, gto_planning
    from grasptrajopt_tpu_torch import testing as port_testing
    from grasptrajopt_tpu_torch.envs import fake_pybullet
    from grasptrajopt_tpu_torch.ops import interp, nn
    from grasptrajopt_tpu_torch.planning.gto_planner import GTOPlanner
    from grasptrajopt_tpu_torch.planning.ik_solver import IKSolver
    from grasptrajopt_tpu_torch.utils import cli

    monkeypatch.setitem(sys.modules, "pybullet", sys.modules.get("pybullet"))
    assert fake_pybullet.install(force=True)
    scene_replica = None
    for name in ("pybullet_api", "scene_replica"):
        scene_replica = importlib.reload(importlib.import_module(f"grasptrajopt_tpu_torch.envs.{name}"))
    mk, mg = port_testing.make_synthetic_gto_robot, port_testing.make_synthetic_gripper
    monkeypatch.setattr(cli, "make_synthetic_gto_robot", lambda *a, **k: mk(*a, **{**k, "points_per_link": 10}))
    monkeypatch.setattr(cli, "make_synthetic_gripper", lambda *a, **k: mg(*a, **{**k, "points_per_link": 10}))
    init = scene_replica.SceneReplicaEnv.__init__
    monkeypatch.setattr(scene_replica.SceneReplicaEnv, "__init__",
                        lambda self, *a, **k: init(self, *a, **{**k, "window_width": 96, "window_height": 72}))
    no_wait = types.SimpleNamespace(sleep=lambda s: None, time=time.time)
    monkeypatch.setattr(scene_replica, "time", no_wait)
    monkeypatch.setattr(gto_planning, "time", no_wait)
    plan_init, ik_init = GTOPlanner.__init__, IKSolver.__init__
    monkeypatch.setattr(GTOPlanner, "__init__", lambda self, *a, **k: plan_init(self, *a, **{**k, "iterations": 3}))
    monkeypatch.setattr(IKSolver, "__init__", lambda self, *a, **k: ik_init(self, *a, **{**k, "iterations": 10}))

    tree = str(tmp_path / "tree")
    port_testing.make_scenereplica_tree(tree, 10, grasps_per_object=4)
    run = ["-r", "synth7", "--assets_dir", tree, "-s", "10", "--device", "cuda"]
    nn.min_d2_launches = interp.field_lookup_launches = 0
    out = gto_planning.main(run + ["--outdir", str(tmp_path / "results")])
    torch.cuda.synchronize()
    with open(out) as f:
        results = json.load(f)["10"]
    plans = [np.asarray(r["plan"]) for objs in results.values() for r in objs.values() if r["plan"] is not None]
    assert set(results) == {"nearest_first", "random"} and len(plans) == 4
    assert all(p.shape == (9, 50) and np.isfinite(p).all() for p in plans)
    assert nn.min_d2_launches == 3 * 4 and interp.field_lookup_launches == 7 * 4
    nn.min_d2_launches = 0
    agg = evaluate_plans.main(run + ["-f", out])
    torch.cuda.synchronize()
    assert nn.min_d2_launches == 4 and agg["trials"] == 4
    fake_pybullet.disconnect()


# -- K5: the block-tridiagonal KKT solve ------------------------------------------

K5_RTOL_F64 = 1e-10  # float64: K5 against the plain loop, relative to the largest |x|


def _kkt(dev, lead, F, n, lower, seed=0):
    """A float64 SPD block-tridiagonal system on `dev`: D_t = A A^T +
    (2n + 2) I, so no block row's off-diagonal blocks outweigh its diagonal;
    `lower` "solver" is the LM's expanded -w I view (stride 0, w = 1),
    "dense" random blocks of norm ~0.3 x 2 sqrt(n)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    A = torch.randn(lead + (F, n, n), generator=g, dtype=torch.float64)
    eye = torch.eye(n, dtype=torch.float64)
    D = A @ A.transpose(-1, -2) + (2 * n + 2) * eye
    rhs = torch.randn(lead + (F, n), generator=g, dtype=torch.float64)
    if lower == "solver":
        L = (-1.0 * eye).to(dev).expand(lead + (F - 1, n, n))
    else:
        L = (0.3 * torch.randn(lead + (F - 1, n, n), generator=g, dtype=torch.float64)).to(dev)
    return D.to(dev), L, rhs.to(dev)


def _max_rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("lower", ["solver", "dense"])
@pytest.mark.parametrize(
    "lead,F,n",
    [
        ((2_048,), 48, 7),  # the cell's solve
        ((512,), 48, 7),  # the serving path
        ((32,), 48, 7),  # the bench default
        ((4,), 198, 7),  # T = 200 without cyclic reduction
        ((3,), 48, 1),
        ((3,), 48, 7),
        ((3,), 48, 8),
        ((3,), 48, 16),
        ((2, 5), 3, 7),  # two leading dims, a ragged warp
        ((5,), 1, 7),  # one block: no lower
    ],
)
def test_block_tridiag_kernel_matches_plain(cuda, lead, F, n, lower):
    """K5 against the plain loop: in float64 within 1e-10 relative; in
    float32 no farther from the float64 oracle than twice the float32
    plain loop; two launches on the same inputs give the same bits."""
    from grasptrajopt_tpu_torch.ops import block_tridiag as bt

    D, L, rhs = _kkt(cuda, lead, F, n, lower)
    before = bt.block_tridiag_launches
    got = bt.block_tridiag_solve(D, L, rhs)
    torch.cuda.synchronize()
    assert bt.block_tridiag_launches == before + 1
    want = bt.block_tridiag_solve_reference(D, L, rhs)
    assert got.shape == rhs.shape and got.dtype == torch.float64
    assert _max_rel(got, want) <= K5_RTOL_F64

    D32, r32 = D.float(), rhs.float()
    L32 = L.float() if lower == "dense" else (-torch.eye(n, device=cuda)).expand(L.shape)  # stride 0 kept
    oracle = bt.block_tridiag_solve_reference(D32.double(), L32.double(), r32.double())
    got32 = bt.block_tridiag_solve(D32, L32, r32)
    plain32 = bt.block_tridiag_solve_reference(D32, L32, r32)
    err_k5 = float((got32.double() - oracle).abs().max())
    err_plain = float((plain32.double() - oracle).abs().max())
    assert got32.dtype == torch.float32 and err_k5 <= 2 * err_plain, (err_k5, err_plain)
    assert torch.equal(bt.block_tridiag_solve(D32, L32, r32), got32)
    assert torch.equal(bt.block_tridiag_solve(D, L, rhs), got)


def test_block_tridiag_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from grasptrajopt_tpu_torch.ops import block_tridiag as bt

    D, L, rhs = _kkt(cuda, (3,), 6, 7, "dense")
    D17, L17, r17 = _kkt(cuda, (3,), 6, 17, "dense")
    before = bt.block_tridiag_launches
    with pytest.raises(ValueError):  # n = 17: beyond MAX_UNROLL_N
        bt.block_tridiag_solve(D17, L17, r17)
    with pytest.raises(TypeError):
        bt.block_tridiag_solve(D.half(), L.half(), rhs.half())
    with pytest.raises(ValueError):  # F = 6 blocks, 4 couplings
        bt.block_tridiag_solve(D, L[:, :4], rhs)
    with pytest.raises(ValueError):  # a non-contiguous diag
        bt.block_tridiag_solve(D.transpose(-1, -2), L, rhs)
    with pytest.raises(ValueError):  # the right-hand side on the CPU
        bt.block_tridiag_solve(D, L, rhs.cpu())
    assert bt.block_tridiag_launches == before


def test_block_tridiag_refused_launch_raises(cuda, monkeypatch):
    """A block the card refuses (2,048 threads) raises from the launch; the
    wrapper never hands back another path's output."""
    from grasptrajopt_tpu_torch.ops import block_tridiag as bt

    D, L, rhs = _kkt(cuda, (64,), 12, 7, "solver")
    monkeypatch.setattr(bt, "K5_THREADS", 2_048)
    before = bt.block_tridiag_launches
    with pytest.raises(RuntimeError, match="K5 launch"):
        bt.block_tridiag_solve(D, L, rhs)
    assert bt.block_tridiag_launches == before
    monkeypatch.undo()
    torch.cuda.synchronize()  # the refusal left no error behind
    assert _max_rel(bt.block_tridiag_solve(D, L, rhs), bt.block_tridiag_solve_reference(D, L, rhs)) <= K5_RTOL_F64


def test_bench_step_launches_k5_once_an_iteration(cuda):
    """One SolveBench step at B = 32 (3 LM iterations) solves its KKT
    systems through K5: exactly 3 launches."""
    from grasptrajopt_tpu_torch import bench as pb
    from grasptrajopt_tpu_torch.ops import block_tridiag as bt
    from grasptrajopt_tpu_torch.testing import make_synthetic_gto_robot

    robot = make_synthetic_gto_robot(device=cuda, dtype=torch.float32, points_per_link=8)
    bench = pb.SolveBench(robot, pb.SolveBenchConfig(batch=32, goal_capacity=2))
    before = bt.block_tridiag_launches
    Q, cost, _ = bench.step()
    torch.cuda.synchronize()
    assert bt.block_tridiag_launches == before + 3
    assert bool(torch.isfinite(Q).all()) and bool(torch.isfinite(cost).all())
