"""The port's field lookups against the JAX package in float64: K4's plain
version (`field_lookup_packed_soa_grad`, taken by the wrapper for CPU
tensors) with shared, stacked and per-point row bases and strided input,
the packed row gather, `field_lookup_trilinear(_packed)` and
`VoxelGrid.lookup`, to 1e-12; and the host-side argument handling of the
kernel's launch path (point stride, row bases)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grasptrajopt_tpu.fields.voxel_grid import VoxelGrid as JaxGrid
from grasptrajopt_tpu.ops import interp as jinterp
from grasptrajopt_tpu_torch.fields.voxel_grid import VoxelGrid
from grasptrajopt_tpu_torch.ops import interp
from torch_parity import np_, t64

ORIGIN = (-0.42, -0.55, -0.31)
SHAPE = (9, 11, 7)
RES = 0.05
S = SHAPE[0] * SHAPE[1] * SHAPE[2]
B, T, P = 3, 4, 25
TOL = 1e-12


def _points(rng, lead):
    """Points over the grid and 0.1 m beyond it, some exactly on cell
    faces: (..., 3)."""
    lo = np.asarray(ORIGIN) - 0.1
    hi = np.asarray(ORIGIN) + (np.asarray(SHAPE) - 1) * RES + 0.1
    pts = rng.uniform(lo, hi, size=lead + (3,))
    face = rng.integers(0, np.asarray(SHAPE), size=lead + (3,))
    on_face = rng.uniform(size=lead + (3,)) < 0.2
    return np.where(on_face, np.asarray(ORIGIN) + face * RES, pts)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    fields = rng.uniform(0.0, 0.1, size=(B, 2, S))
    return rng, fields, _points(rng, (B, T, P))


def _tables(fields):
    """Port and JAX stacked tables (B*2S, 8) of the same fields."""
    port = interp.pack_corners(t64(fields), SHAPE).reshape(-1, 8)
    jax_ = jnp.concatenate([jinterp.pack_corners(fields[b, f], SHAPE) for b in range(B) for f in range(2)])
    return port, jax_


def _phase_row():
    return (np.arange(T) >= T - 1).astype(np.int64)[:, None] * S  # (T, 1)


def _check(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_(g), np.asarray(w), atol=TOL, rtol=0)


def test_pack_corners_and_row_gather(data):
    rng, fields, _ = data
    port, jax_ = _tables(fields)
    np.testing.assert_array_equal(np_(port), np.asarray(jax_))
    offs = rng.integers(0, 2 * B * S, size=(5, 40))
    np.testing.assert_array_equal(np_(port[torch.as_tensor(offs)]), np.asarray(jax_[offs]))


@pytest.mark.parametrize("layout", ["shared", "stacked", "per_point"])
def test_packed_soa_grad_matches_jax(data, layout):
    """Value and gradient, one shared table (T, 1) row bases, a stacked
    table (B, T, 1) and one row base per point (B, T, P)."""
    rng, fields, pts = data
    port, jax_ = _tables(fields)
    if layout == "shared":
        row = _phase_row()
    elif layout == "stacked":
        row = _phase_row()[None] + (np.arange(B) * 2 * S)[:, None, None]
    else:
        row = rng.integers(0, 2 * B, size=(B, T, P)) * S
    x, y, z = (pts[..., i] for i in range(3))
    want = jinterp.field_lookup_packed_soa_grad(
        jax_, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), jnp.asarray(ORIGIN), SHAPE, RES,
        row_offset=jnp.asarray(row),
    )
    before = interp.field_lookup_launches
    got = interp.field_lookup_packed_soa_grad(
        port, t64(x), t64(y), t64(z), ORIGIN, SHAPE, RES, row_offset=torch.as_tensor(row)
    )
    assert interp.field_lookup_launches == before  # CPU tensors take the plain version
    _check(got, want)
    ref = interp.field_lookup_packed_soa_grad_reference(
        port, t64(x), t64(y), t64(z), t64(ORIGIN), SHAPE, RES, row_offset=torch.as_tensor(row)
    )
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    # outside the grid the clamped fraction saturates: zero gradient there
    u = (pts - np.asarray(ORIGIN)) / RES
    out_x = (u[..., 0] < 0) | (u[..., 0] > SHAPE[0] - 1)
    assert out_x.any() and np.all(np_(got[1])[out_x] == 0.0)


def test_strided_aos_input_matches_contiguous(data):
    """The x / y / z views of an AoS (..., 3) tensor (3 elements apart)."""
    _, fields, pts = data
    port, jax_ = _tables(fields)
    aos = t64(pts)
    row = torch.as_tensor(_phase_row())
    got = interp.field_lookup_packed_soa_grad(port, aos[..., 0], aos[..., 1], aos[..., 2], ORIGIN, SHAPE, RES, row)
    want = jinterp.field_lookup_packed_soa_grad(
        jax_, *(jnp.asarray(pts[..., i]) for i in range(3)), jnp.asarray(ORIGIN), SHAPE, RES,
        row_offset=jnp.asarray(_phase_row()),
    )
    _check(got, want)


def test_trilinear_lookups_and_voxel_grid_match_jax(data):
    rng, fields, pts = data
    f = fields[0, 0]
    q = pts.reshape(-1, 3)
    pg, jg = VoxelGrid(ORIGIN, SHAPE, RES), JaxGrid(ORIGIN, SHAPE, RES)
    want = jinterp.field_lookup_trilinear(jnp.asarray(f), jnp.asarray(q), jnp.asarray(ORIGIN), SHAPE, RES)
    got = interp.field_lookup_trilinear(t64(f), t64(q), t64(ORIGIN), SHAPE, RES)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=TOL, rtol=0)
    for mode in ("trilinear", "nearest"):
        np.testing.assert_allclose(
            np_(pg.lookup(t64(f), t64(q), mode)), np.asarray(jg.lookup(jnp.asarray(f), jnp.asarray(q), mode)),
            atol=TOL, rtol=0,
        )
    with pytest.raises(ValueError):
        pg.lookup(t64(f), t64(q), "cubic")
    port, jax_ = _tables(fields)
    row = 3 * S
    want_p = jinterp.field_lookup_trilinear_packed(jax_, jnp.asarray(q), jnp.asarray(ORIGIN), SHAPE, RES, row)
    got_p = interp.field_lookup_trilinear_packed(port, t64(q), t64(ORIGIN), SHAPE, RES, row)
    np.testing.assert_allclose(np_(got_p), np.asarray(want_p), atol=TOL, rtol=0)
    # the packed lookup is the unpacked one of slab 3 (object 1's first field)
    np.testing.assert_allclose(
        np_(got_p), np_(interp.field_lookup_trilinear(t64(fields[1, 1]), t64(q), t64(ORIGIN), SHAPE, RES)),
        atol=TOL, rtol=0,
    )


def test_point_stride_of_the_launch_path():
    aos = torch.zeros((2, 5, 7, 3))
    assert interp._uniform_stride(aos[..., 1]) == 3
    assert interp._uniform_stride(torch.zeros((2, 5, 7))) == 1
    assert interp._uniform_stride(torch.zeros((1, 5, 1))) == 1
    assert interp._uniform_stride(torch.zeros(())) == 1
    with pytest.raises(ValueError):
        interp._uniform_stride(torch.zeros((4, 6))[:, :3])  # rows 6 apart, points 1 apart


def test_row_bases_of_the_launch_path():
    dev = torch.device("cpu")
    rb, div = interp._row_base(5, (2, 3, 4), dev)
    assert rb.tolist() == [5] and div == 24
    phase = torch.tensor([[0], [0], [10]])  # (T, 1)
    rb, div = interp._row_base(phase, (2, 3, 4), dev)
    assert rb.dtype == torch.int32 and rb.reshape(-1).tolist() == [0, 0, 10, 0, 0, 10] and div == 4
    stacked = phase + torch.tensor([0, 100])[:, None, None]
    rb, div = interp._row_base(stacked, (2, 3, 4), dev)
    assert rb.reshape(-1).tolist() == [0, 0, 10, 100, 100, 110] and div == 4
    per_point = torch.arange(24).reshape(2, 3, 4)
    rb, div = interp._row_base(per_point, (2, 3, 4), dev)
    assert rb.reshape(-1).tolist() == list(range(24)) and div == 1
    with pytest.raises(ValueError):
        interp._row_base(torch.zeros((2, 3, 1)), (2, 3, 4), dev)  # float offsets
