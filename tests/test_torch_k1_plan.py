"""K1's launch plan, its (B, N, 4) packer and its plain version, on the
CPU: the plan's cluster split and query tiles at the shapes the main path
launches, and the packer and plain version against the JAX package's
Pallas kernel in interpret mode and its float64 fallback, masks included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grasptrajopt_tpu.ops import nn as jnn
from grasptrajopt_tpu_torch.ops import nn as pnn
from torch_parity import np_, t64

H100_SMS = 132

# (B, M queries, N points) of the main path's K1 launches
SLICE = {"obstacle pass": (16, 95_760, 12_288), "target pass": (16, 95_760, 2_048)}
PIPELINE_B1 = {
    "tabletop field build": (1, 95_760, 25_600),
    "replay of one plan": (1, 50_000, 25_600),
    "shelf replay over two fused views": (1, 50_000, 51_200),
    "grasp filter": (1, 9_600, 25_600),
    "shelf field build": (1, 766_080, 14_336),
}
OTHER = {
    "pre-filter": (16, 9_600, 12_288),
    "ragged": (3, 1_025, 2_049),
    "one point": (2, 1, 1),
    "one tile of points": (1, 50_000, 300),
}
ALL = {**SLICE, **PIPELINE_B1, **OTHER}


def _grid_blocks(B, M, tile_m, S):
    return B * -(-M // tile_m) * S


@pytest.mark.parametrize("name", sorted(ALL))
def test_plan_splits_cover_the_cloud(name):
    """S is a power of two up to the portable 8; the S shares are
    contiguous, equal to a point, at least a tile each where S > 1, and
    together they are the N points."""
    B, M, N = ALL[name]
    tile_m, S = pnn._k1_launch_plan(B, M, N, H100_SMS)
    assert S in (1, 2, 4, 8)
    assert pnn.K1_MIN_TILE_M <= tile_m <= pnn.K1_TILE_M and tile_m % pnn.K1_QPT == 0
    shares = pnn._shares(N, S)
    assert len(shares) == S and shares[0][0] == 0 and shares[-1][1] == N
    assert all(shares[i][1] == shares[i + 1][0] for i in range(S - 1))
    sizes = [b - a for a, b in shares]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    if S > 1:
        assert min(sizes) >= pnn.K1_TILE_N


@pytest.mark.parametrize("name", sorted(SLICE) + ["shelf field build"])
def test_plan_does_not_split_where_the_queries_fill_the_card(name):
    B, M, N = ALL[name]
    tile_m, S = pnn._k1_launch_plan(B, M, N, H100_SMS)
    assert (tile_m, S) == (pnn.K1_TILE_M, 1)


@pytest.mark.parametrize("name", sorted(PIPELINE_B1))
def test_plan_fills_the_card_at_b1(name):
    """At the pipeline's B = 1 launches the grid reaches the fill target,
    or S is as large as N allows and the query tile as small as it goes."""
    B, M, N = ALL[name]
    tile_m, S = pnn._k1_launch_plan(B, M, N, H100_SMS)
    target = pnn.K1_WAVES * H100_SMS * pnn.K1_BLOCKS_PER_SM
    blocks = _grid_blocks(B, M, tile_m, S)
    if blocks < target:
        assert tile_m == pnn.K1_MIN_TILE_M
        assert S == pnn.K1_MAX_SPLIT or 2 * S > N // pnn.K1_TILE_N
    # the smallest S that reaches it: half of it would not
    if S > 1:
        assert _grid_blocks(B, M, tile_m, S // 2) < target
    # the unsplit grid is short of the card at every B = 1 shape but the
    # shelf's 766,080-query field build
    assert (S == 1) == (name == "shelf field build")


def test_plan_splits_only_as_far_as_the_cloud_has_tiles():
    # 300 points are one tile: no split, however short the grid
    assert pnn._k1_launch_plan(1, 50_000, 300, H100_SMS)[1] == 1
    assert pnn._k1_launch_plan(1, 50_000, 3 * pnn.K1_TILE_N, H100_SMS)[1] == 2
    # a card with fewer SMs, or fewer resident blocks, wants fewer blocks
    full = pnn._k1_launch_plan(1, 95_760, 25_600, H100_SMS)
    assert pnn._k1_launch_plan(1, 95_760, 25_600, 16) == (pnn.K1_TILE_M, 1)
    assert pnn._k1_launch_plan(1, 95_760, 25_600, H100_SMS, blocks_per_sm=2)[1] < full[1]


@pytest.mark.parametrize("split", [0, 3, 16, -1])
def test_forced_split_outside_the_cluster_sizes_raises(split):
    q = torch.zeros((4, 3))
    r4 = pnn._pack_ref4(torch.ones((1, 5, 3)))
    with pytest.raises(ValueError):
        pnn.min_d2_batched(q, r4, split=split)


@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_forced_split_on_the_cpu_is_the_plain_version(split):
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(50, 3)))
    r4 = pnn._pack_ref4(torch.from_numpy(rng.normal(size=(2, 70, 3))))
    before = pnn.min_d2_launches
    got = pnn.min_d2_batched(q, r4, split=split)
    assert pnn.min_d2_launches == before
    assert torch.equal(got, pnn.min_d2_batched_reference(q, r4))


def test_wrapper_refuses_the_transposed_layout():
    q = torch.zeros((4, 3))
    rT = pnn._pack_ref4(torch.ones((1, 5, 3))).transpose(1, 2).contiguous()  # (B, 4, N)
    with pytest.raises(ValueError):
        pnn.min_d2_batched(q, rT)


@pytest.mark.parametrize("B,N,masked", [(1, 1, False), (2, 300, True), (3, 1_030, True)])
def test_pack_ref4_matches_the_jax_packer(B, N, masked):
    """Row n of cloud b is the JAX package's column n of (B, 4, Np): x, y,
    z and the 3e38 penalty of an invalid point; the JAX padding columns
    have no row."""
    rng = np.random.default_rng(B * N)
    r = rng.normal(size=(B, N, 3)).astype(np.float32)
    mask = rng.uniform(size=(B, N)) > 0.3 if masked else None
    rT = np.asarray(jnn._pack_refT(jnp.asarray(r), None if mask is None else jnp.asarray(mask), tn=128))
    r4 = pnn._pack_ref4(torch.from_numpy(r), None if mask is None else torch.from_numpy(mask))
    assert r4.shape == (B, N, 4) and r4.is_contiguous()
    np.testing.assert_array_equal(np_(r4), np.swapaxes(rT[:, :, :N], 1, 2))


@pytest.mark.parametrize("B,M,N", [(1, 65, 129), (2, 200, 600), (4, 7, 1)])
def test_plain_k1_matches_pallas_interpret_with_masks(B, M, N):
    """The plain K1 on _pack_ref4 rows against min_d2_batched_pallas
    (interpret mode, f32, tm=64, tn=128) at ragged sizes, one cloud all
    invalid where B > 1: within 1e-6 + 1e-6 relative (a few float32 ulp:
    XLA and torch may round the sums differently), the all-invalid row
    equal."""
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(M + N)
    q = rng.normal(size=(M, 3)).astype(np.float32)
    r = rng.normal(size=(B, N, 3)).astype(np.float32)
    mask = rng.uniform(size=(B, N)) > 0.25
    mask[:, 0] = True
    if B > 1:
        mask[1] = False
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jnn.min_d2_batched_pallas(
            jnn._pack_query8(jnp.asarray(q), tm=64), jnn._pack_refT(jnp.asarray(r), jnp.asarray(mask), tn=128),
            tm=64, tn=128,
        ))[:, :M]
    got = np_(pnn.min_d2_batched(torch.from_numpy(q), pnn._pack_ref4(torch.from_numpy(r), torch.from_numpy(mask))))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    if B > 1:
        np.testing.assert_array_equal(got[1], want[1])
        assert (got[1] >= 1e38).all()


@pytest.mark.parametrize("per_cloud", [False, True])
def test_min_sqdist_d2_matches_jax_fallback_f64_with_masks(per_cloud):
    """min_sqdist_d2 (packer, plain K1) in float64 against the JAX
    package's fallback, cloud by cloud, shared or per-cloud queries: 1e-12."""
    rng = np.random.default_rng(11)
    B, M, N = 3, 80, 150
    q = rng.normal(size=(B, M, 3) if per_cloud else (M, 3))
    r = rng.normal(size=(B, N, 3))
    mask = rng.uniform(size=(B, N)) > 0.4
    mask[:, 3] = True
    got = pnn.min_sqdist_d2(t64(q), t64(r), torch.from_numpy(mask))
    assert got.dtype == torch.float64 and got.shape == (B, M)
    for b in range(B):
        qb = q[b] if per_cloud else q
        want = jnn.min_sqdist_d2(jnp.asarray(qb), jnp.asarray(r[b]), jnp.asarray(mask[b]), use_pallas=False)
        np.testing.assert_allclose(np_(got[b]), np.asarray(want), atol=1e-12, rtol=0)
