"""K2 / K3's launch plan and the kernel's argmin walk, on the CPU.

The plan (`nn._k2_launch_plan`) at every shape the main path launches:
the query tile and the cluster split that fill the card, shares that
cover the cloud and fit a block's shared memory, the forced split
validated. The walk: a pure-Python emulation of what each block of
csrc/nearest.cu does (its shares, chunks and sub-tiles, the running
minimum, the sub-tile where it last strictly fell, the rescan of that
sub-tile, the merge of the S partials by rank) on a float32 distance
matrix computed as the plain version computes it; its index must be
torch.min's first index at every S, on ties placed across share and
sub-tile boundaries."""

import numpy as np
import pytest
import torch

from grasptrajopt_tpu_torch.fields.scene_points import PAD_COORD
from grasptrajopt_tpu_torch.ops import nn

H100_SMS = 132

# (C sets, M queries, N points) of the main path's K2 / K3 launches
FULL = {  # the query tiles alone fill the card
    "exact tier obstacle pass": (16, 1_600_000, 4_096),
    "exact tier target pass": (16, 1_600_000, 1_024),
    "one-object exact call": (1, 1_600_000, 4_096),
}
SHORT = {  # they do not: the mobile occupancy builds (K3, shared queries)
    "tabletop occupancy build": (1, 2_867, 6_438),
    "shelf occupancy build": (1, 211_176, 11_155),
}
OTHER = {
    "ragged": (3, 1_025, 4_097),
    "one point": (2, 1, 1),
    "a large cloud": (1, 50_000, 40_000),
}
ALL = {**FULL, **SHORT, **OTHER}


def _blocks(C, M, tile_m, S):
    return C * -(-M // tile_m) * S


@pytest.mark.parametrize("max_split", [8, 16])
@pytest.mark.parametrize("name", sorted(ALL))
def test_plan_shares_cover_the_cloud(name, max_split):
    """S is a power of two up to the card's largest cluster; the S shares
    are contiguous, equal to a point, together the N points, and at least
    256 points each where S > 1."""
    C, M, N = ALL[name]
    tile_m, S = nn._k2_launch_plan(C, M, N, H100_SMS, max_split=max_split)
    assert S in (1, 2, 4, 8, 16) and S <= max_split
    assert nn.K2_MIN_TILE_M <= tile_m <= nn.K2_TILE_M and tile_m % nn.K2_QPT == 0
    shares = nn._shares(N, S)
    assert len(shares) == S and shares[0][0] == 0 and shares[-1][1] == N
    assert all(shares[i][1] == shares[i + 1][0] for i in range(S - 1))
    sizes = [b - a for a, b in shares]
    assert max(sizes) - min(sizes) <= 1
    if S > 1:
        assert min(sizes) >= 256


@pytest.mark.parametrize("max_split", [8, 16])
@pytest.mark.parametrize("name", sorted(ALL))
def test_plan_fills_the_card(name, max_split):
    """The grid reaches K2_WAVES x SMs x blocks per SM, or S is as large
    as the card and the cloud allow and the query tile as small as it
    goes; S is the smallest that reaches the aim."""
    C, M, N = ALL[name]
    tile_m, S = nn._k2_launch_plan(C, M, N, H100_SMS, max_split=max_split)
    target = nn.K2_WAVES * H100_SMS * nn.K2_BLOCKS_PER_SM
    if _blocks(C, M, tile_m, S) < target:
        assert tile_m == nn.K2_MIN_TILE_M
        assert S == max_split or 2 * S > N // 256
    if S > 1:
        assert _blocks(C, M, tile_m, S // 2) < target


@pytest.mark.parametrize("name", sorted(FULL))
def test_plan_does_not_split_where_the_queries_fill_the_card(name):
    assert nn._k2_launch_plan(*FULL[name], H100_SMS) == (nn.K2_TILE_M, 1)


def test_plan_splits_the_occupancy_builds():
    """The tabletop build (2,867 queries: 6 tiles of 512) takes the
    largest cluster the card admits and the smallest query tile; the
    shelf's (413 tiles, short of two waves) a split at full tiles, below
    the largest."""
    assert nn._k2_launch_plan(*SHORT["tabletop occupancy build"], H100_SMS) == (nn.K2_MIN_TILE_M, 16)
    assert nn._k2_launch_plan(*SHORT["tabletop occupancy build"], H100_SMS, max_split=8) == (nn.K2_MIN_TILE_M, 8)
    tile_m, S = nn._k2_launch_plan(*SHORT["shelf occupancy build"], H100_SMS)
    assert tile_m == nn.K2_TILE_M and 1 < S < 16
    assert _blocks(*SHORT["tabletop occupancy build"][:2], nn.K2_TILE_M, 1) == 6
    assert _blocks(*SHORT["shelf occupancy build"][:2], nn.K2_TILE_M, 1) < H100_SMS * nn.K2_WAVES * nn.K2_BLOCKS_PER_SM


def test_plan_takes_any_cloud():
    """Shares stream through the ring, so the cloud's size sets no least
    S: 40,000 points where the queries fill the card are one share, and
    any power of two up to 16 may be forced."""
    assert nn._k2_launch_plan(16, 1_600_000, 40_000, H100_SMS) == (nn.K2_TILE_M, 1)
    assert nn._k2_launch_plan(1, 1_000, 300_000, H100_SMS)[1] == 16
    for split in (1, 2, 4, 8, 16):
        assert nn._k2_launch_plan(1, 1_000, 300_000, H100_SMS, split=split) == (nn.K2_TILE_M, split)


def test_plan_follows_the_card():
    """Fewer SMs or fewer resident blocks want fewer blocks."""
    C, M, N = SHORT["shelf occupancy build"]
    assert nn._k2_launch_plan(C, M, N, 16) == (nn.K2_TILE_M, 1)
    assert nn._k2_launch_plan(C, M, N, H100_SMS, blocks_per_sm=1)[1] == 1


@pytest.mark.parametrize("split", [0, 3, 32, -1])
def test_forced_split_outside_the_cluster_sizes_raises(split):
    q = torch.zeros((4, 3))
    r4 = nn._pack_ref4(torch.ones((1, 5, 3)))
    with pytest.raises(ValueError):
        nn.nearest_batched(q, r4, split=split)


@pytest.mark.parametrize("split", [1, 2, 4, 8, 16])
def test_forced_split_on_the_cpu_is_the_plain_version(split):
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(2, 50, 3)))
    r4 = nn._pack_ref4(torch.from_numpy(rng.normal(size=(2, 70, 3))))
    nrm = torch.from_numpy(rng.normal(size=(2, 70, 3)))
    before = (nn.nearest_launches, nn.min_sqdist_launches)
    got = nn.nearest_batched(q, r4, nrm, split=split)
    assert (nn.nearest_launches, nn.min_sqdist_launches) == before
    for a, b in zip(got, nn.nearest_batched_reference(q, r4, nrm)):
        assert torch.equal(a, b)


# -- the kernel's walk, emulated ---------------------------------------------


def emulate_walk(d2, S, sub=nn.K2_SUB, chunk=nn.K2_CHUNK):
    """(d2 (M,), idx (M,)) of one set as csrc/nearest.cu computes them from
    the (M, N) float32 pair values `d2`: S blocks each walk a share in
    chunks of sub-tiles with a running minimum, record the sub-tile in
    which it last strictly fell, rescan that sub-tile for the first index
    equal to the minimum, and the partials meet by rank (strict '<')."""
    M, N = d2.shape
    rows = torch.arange(M)
    inf = torch.full((M,), float("inf"), dtype=d2.dtype)
    v = a = None
    for rank, (p0, p1) in enumerate(nn._shares(N, S)):
        best, low, rec = inf.clone(), inf.clone(), torch.full((M,), p0)
        for c0 in range(p0, p1, chunk):
            c1 = min(c0 + chunk, p1)
            for j in range(c0, c1, sub):
                best = torch.minimum(best, d2[:, j : min(j + sub, c1)].amin(dim=1))
                rec = torch.where(best < low, j, rec)
                low = best.clone()
        at = rec.clone()
        for u in reversed(range(sub)):
            n = rec + u
            inside = n < p1
            hit = inside & (d2[rows, n.clamp(max=N - 1)] == best)
            at = torch.where(hit, n, at)
        if rank == 0:
            v, a = best, at
        else:
            take = best < v
            v, a = torch.where(take, best, v), torch.where(take, at, a)
    return torch.clamp(v, min=0.0), a


def _pair_d2(q, r4):
    """(M, N) float32 pair values, the plain version's arithmetic."""
    acc = (q[:, None, 0] - r4[None, :, 0]) ** 2
    acc = acc + (q[:, None, 1] - r4[None, :, 1]) ** 2
    acc = acc + (q[:, None, 2] - r4[None, :, 2]) ** 2
    return acc + r4[None, :, 3]


def _tied_set(kind, N=2_000, seed=0):
    """(queries (M, 3), rows (N, 4)) float32 of one set whose minima tie."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(-1, 1, size=(N, 3)).astype(np.float32)
    pen = np.zeros(N, np.float32)
    if kind == "boundary duplicates":
        # every share boundary of S = 2..16 (multiples of N / 16) and the
        # sub-tile boundaries after them: row hi repeats row lo
        lo_hi = []
        for b in range(N // 16, N, N // 16):
            lo_hi += [(b - 3, b), (b + 1, b + 5), (b + nn.K2_SUB - 2, b + nn.K2_SUB + 1)]
        lo_hi += [(nn.K2_CHUNK - 1, nn.K2_CHUNK + 7)]  # across a chunk
        for lo, hi in lo_hi:
            r[hi] = r[lo]
        lows = [lo for lo, _ in lo_hi]
        q = np.concatenate([r[lows] + np.float32(1e-4), r[lows], rng.uniform(-1, 1, size=(300, 3))])
    elif kind == "grid ties":
        # points and queries on a coarse integer lattice: many rows
        # coincide and many queries sit at equal distance from several
        r = rng.integers(-3, 4, size=(N, 3)).astype(np.float32)
        q = rng.integers(-3, 4, size=(500, 3)).astype(np.float32) + np.float32(0.5) * rng.integers(0, 2, size=(500, 3))
    elif kind == "all invalid":
        pen[:] = nn.PENALTY_BIG
        q = rng.uniform(-1, 1, size=(400, 3))
    elif kind == "all PAD_COORD":
        r[:] = PAD_COORD
        q = rng.uniform(-1, 1, size=(400, 3))
    else:  # "masked": a third of the points invalid, duplicates among them
        pen[rng.uniform(size=N) < 0.33] = nn.PENALTY_BIG
        r[1_000:1_100] = r[900:1_000]
        q = np.concatenate([r[900:1_000], rng.uniform(-1, 1, size=(300, 3))])
    q = torch.from_numpy(np.asarray(q, np.float32))
    return q, torch.from_numpy(np.concatenate([r, pen[:, None]], axis=1))


@pytest.mark.parametrize("S", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("kind", ["boundary duplicates", "grid ties", "all invalid", "all PAD_COORD", "masked"])
def test_walk_emulation_finds_the_first_index(kind, S):
    """The emulated kernel's (d2, index) is torch.min's (value, first
    index) on the same float32 pair values, and the plain version's, at
    every cluster size."""
    q, r4 = _tied_set(kind)
    d2 = _pair_d2(q, r4)
    want_v, want_i = torch.min(d2, dim=1)
    got_v, got_i = emulate_walk(d2, S)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_v, torch.clamp(want_v, min=0.0))
    pv, pi = nn.nearest_batched_reference(q, r4[None])
    assert torch.equal(got_i.to(torch.int32), pi[0]) and torch.equal(got_v, pv[0])
    if kind in ("all invalid", "all PAD_COORD"):
        assert bool((got_i == 0).all())
    if kind == "all invalid":
        assert bool((got_v >= 1e38).all())
    if kind == "boundary duplicates":  # the ties do occur: a later copy is as near
        assert int((d2 == want_v[:, None]).sum(dim=1).max()) >= 2


def test_walk_emulation_rescan_is_needed():
    """The record alone is not the index: on the boundary-duplicates set
    the first index usually lies inside its sub-tile, not at its start."""
    q, r4 = _tied_set("boundary duplicates")
    _, idx = emulate_walk(_pair_d2(q, r4), 4)
    assert int((idx % nn.K2_SUB != 0).sum()) > len(idx) // 2


def test_constants_match_the_kernel_source():
    """The plan's and the emulation's constants are the kernel's: queries
    a thread, sub-tile, chunk, the largest cluster."""
    import re
    from pathlib import Path

    src = (Path(nn.__file__).parents[1] / "csrc" / "nearest.cu").read_text()

    def value(pattern):
        return int(re.search(pattern, src).group(1))

    assert value(r"constexpr int QPT = (\d+);") == nn.K2_QPT
    assert value(r"constexpr int SUB = (\d+);") == nn.K2_SUB
    assert value(r"constexpr int CHUNK = (\d+);") == nn.K2_CHUNK
    assert value(r"constexpr int MAX_SPLIT = (\d+);") == nn.K2_MAX_SPLIT
    assert nn.K2_TILE_M <= value(r"constexpr int MAX_THREADS = (\d+);") * nn.K2_QPT
