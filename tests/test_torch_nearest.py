"""K2 and K3's functions in the port (`ops/nn.py`: nearest_point_normal,
min_sqdist, signed_distance_with_dir, signed_distance_to_set) against the
JAX package on the CPU, with inputs made by numpy from a seed:

  - the plain versions against the JAX CPU path in float64 (1e-12), on
    tie-free inputs that include PAD_COORD rows;
  - against the Pallas kernels in interpret mode in float32 (1e-5);
  - the lateral-footprint sign guard and the gradients of
    tests/test_pipeline.py's points-mode cases;
  - the tie rule (F1): the first of equally near points wins.

On the CPU the wrappers take the plain versions and launch nothing; the
kernel itself is held against them on the card (tests/test_torch_gpu.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from grasptrajopt_tpu.ops import nn as jnn
from grasptrajopt_tpu_torch.fields.scene_points import PAD_COORD
from grasptrajopt_tpu_torch.ops import nn


def _sets(seed, M=(5, 40), K=300, n_pad=20, dtype=np.float64):
    """Queries (M..., 3) near a padded reference set (K, 3) with unit
    normals; the last n_pad rows are PAD_COORD padding."""
    rng = np.random.default_rng(seed)
    ref = rng.uniform(-0.5, 0.5, size=(K, 3))
    ref[K - n_pad :] = PAD_COORD
    nrm = rng.normal(size=(K, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    q = rng.uniform(-0.6, 0.6, size=tuple(M) + (3,))
    return q.astype(dtype), ref.astype(dtype), nrm.astype(dtype)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_nearest_point_normal_matches_jax_cpu_path():
    q, ref, nrm = _sets(0)
    before = nn.nearest_launches
    d2, pt, nm = nn.nearest_point_normal(_t(q), _t(ref), _t(nrm))
    assert nn.nearest_launches == before
    jd2, jpt, jnm = jnn._nearest_impl(jnp.asarray(q), jnp.asarray(ref), jnp.asarray(nrm), use_pallas=False)
    assert d2.shape == (5, 40) and pt.shape == nm.shape == (5, 40, 3)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), atol=1e-12, rtol=0)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jpt))
    np.testing.assert_array_equal(nm.numpy(), np.asarray(jnm))
    plain = nn.nearest_point_normal_reference(_t(q), _t(ref), _t(nrm))
    for a, b in zip((d2, pt, nm), plain):
        assert torch.equal(a, b)


def test_batch_first_sets_equal_one_set_at_a_time():
    """Queries (C, M, 3) against C sets in one call give what C calls with
    the JAX shapes give."""
    sets = [_sets(s, M=(60,)) for s in (1, 2, 3)]
    q, ref, nrm = (torch.stack([_t(s[i]) for s in sets]) for i in range(3))
    d2, pt, nm = nn.nearest_point_normal(q, ref, nrm)
    sd, dirs = nn.signed_distance_with_dir(q, ref, nrm)
    for c in range(3):
        one = nn.nearest_point_normal(q[c], ref[c], nrm[c])
        for a, b in zip((d2[c], pt[c], nm[c]), one):
            assert torch.equal(a, b)
        sd1, dirs1 = nn.signed_distance_with_dir(q[c], ref[c], nrm[c])
        assert torch.equal(sd[c], sd1) and torch.equal(dirs[c], dirs1)


def test_signed_distance_with_dir_matches_jax():
    q, ref, nrm = _sets(4, M=(200,))
    q[:50] = ref[:50] - 0.01 * nrm[:50]  # just behind a sample: inside
    sd, dirs = nn.signed_distance_with_dir(_t(q), _t(ref), _t(nrm))
    jsd, jdirs = jnn.signed_distance_with_dir(jnp.asarray(q), jnp.asarray(ref), jnp.asarray(nrm))
    np.testing.assert_allclose(sd.numpy(), np.asarray(jsd), atol=1e-12, rtol=0)
    np.testing.assert_allclose(dirs.numpy(), np.asarray(jdirs), atol=1e-10, rtol=0)
    assert (sd.numpy()[:50] < 0).all() and (sd.numpy()[50:] > 0).any()


@pytest.mark.parametrize("M,K", [(300, 700), (1, 1), (1025, 513)])
def test_nearest_matches_pallas_kernel_interpret_mode(M, K):
    q, ref, nrm = _sets(5, M=(M,), K=K, n_pad=min(K - 1, 7), dtype=np.float32)
    with pltpu.force_tpu_interpret_mode():
        jd2, jpt, jnm = jnn.nearest_point_normal_pallas(jnp.asarray(q), jnp.asarray(ref), jnp.asarray(nrm))
    d2, pt, nm = nn.nearest_point_normal(_t(q), _t(ref), _t(nrm))
    assert d2.dtype == torch.float32
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jpt), atol=1e-5, rtol=0)
    np.testing.assert_allclose(nm.numpy(), np.asarray(jnm), atol=1e-5, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_min_sqdist_matches_pallas_kernel_interpret_mode(masked):
    rng = np.random.default_rng(6)
    q = rng.normal(size=(100, 3)).astype(np.float32)
    r = rng.normal(size=(300, 3)).astype(np.float32)
    mask = rng.uniform(size=300) < 0.6 if masked else None
    with pltpu.force_tpu_interpret_mode():
        jd2, jidx = jnn.min_sqdist_pallas(
            jnp.asarray(q), jnp.asarray(r), None if mask is None else jnp.asarray(mask), tm=64, tn=128
        )
    before = nn.min_sqdist_launches
    d2, idx = nn.min_sqdist(_t(q), _t(r), None if mask is None else _t(mask))
    assert nn.min_sqdist_launches == before
    assert idx.dtype == torch.int32
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    if mask is not None:
        assert mask[idx.numpy()].all()


def test_masked_min_sqdist_matches_jax():
    rng = np.random.default_rng(7)
    q = rng.normal(size=(150, 3))
    r = rng.normal(size=(90, 3))
    mask = rng.uniform(size=90) < 0.5
    d2, idx = nn.min_sqdist(_t(q), _t(r), _t(mask))
    jd2, jidx = jnn.min_sqdist(jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask), chunk=64)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), atol=1e-12, rtol=0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    # batch-first masks (C, N), one set all invalid: d2 >= 1e38 and index 0
    masks = torch.stack([_t(mask), torch.zeros(90, dtype=torch.bool)])
    d2b, idxb = nn.min_sqdist(torch.stack([_t(q)] * 2), torch.stack([_t(r)] * 2), masks)
    assert torch.equal(d2b[0], d2) and torch.equal(idxb[0], idx)
    assert bool((d2b[1] >= 1e38).all()) and bool((idxb[1] == 0).all())
    plain = nn.min_sqdist_reference(torch.stack([_t(q)] * 2), torch.stack([_t(r)] * 2), masks)
    assert torch.equal(plain[0], d2b) and torch.equal(plain[1], idxb)


def test_tie_rule_first_index_wins():
    """F1: exact duplicate points. The port's rule is the first index (the
    JAX CPU path's); the TPU kernel would average the duplicates' normals."""
    rng = np.random.default_rng(8)
    base = rng.uniform(-0.5, 0.5, size=(50, 3))
    ref = np.concatenate([base, base])  # row k and row k + 50 coincide
    nrm = np.concatenate([np.tile([0.0, 0.0, 1.0], (50, 1)), np.tile([0.0, 0.0, -1.0], (50, 1))])
    q = np.concatenate([base + 1e-3, rng.uniform(-0.5, 0.5, size=(200, 3))])
    for dt in (torch.float32, torch.float64):
        d2, pt, nm = nn.nearest_point_normal(_t(q).to(dt), _t(ref).to(dt), _t(nrm).to(dt))
        _, idx = nn.min_sqdist(_t(q).to(dt), _t(ref).to(dt))
        assert bool((idx < 50).all())
        assert bool((nm[:, 2] == 1.0).all())
        assert torch.equal(pt, _t(ref).to(dt)[idx.long()])


def test_lateral_footprint_sign_guard():
    """tests/test_pipeline.py's case: a point below the tabletop PLANE but
    far to the side of the sheet is outside."""
    xs, ys = np.meshgrid(np.arange(0.2, 0.9, 0.02), np.arange(-0.6, 0.6, 0.02))
    sheet = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, 0.15)], axis=1)
    nrm = np.tile([0.0, 0.0, 1.0], (sheet.shape[0], 1))
    q = np.array([[0.5, 0.0, 0.10], [0.0, 0.0, 0.05], [0.5, 0.0, 0.20]])
    sd, dirs = nn.signed_distance_with_dir(_t(q), _t(sheet), _t(nrm))
    jsd, jdirs = jnn.signed_distance_with_dir(jnp.asarray(q), jnp.asarray(sheet), jnp.asarray(nrm))
    np.testing.assert_allclose(sd.numpy(), np.asarray(jsd), atol=1e-12, rtol=0)
    np.testing.assert_allclose(dirs.numpy(), np.asarray(jdirs), atol=1e-10, rtol=0)
    assert float(sd[0]) < 0 and abs(float(sd[0]) + 0.05) < 0.01
    assert float(sd[1]) > 0.1
    assert abs(float(sd[2]) - 0.05) < 0.01
    assert float(dirs[0, 2]) > 0.9 and float(dirs[1, 0]) < -0.5


def test_signed_distance_to_set_gradient():
    """The autograd gradient against jax.grad of the JAX custom_jvp and
    against central finite differences (tests/test_pipeline.py's case)."""
    rng = np.random.default_rng(0)
    ref = rng.normal(size=(50, 3))
    normals = ref / np.linalg.norm(ref, axis=1, keepdims=True)
    p = np.array([[0.4, 0.1, -0.2], [1.5, 1.5, 1.5]])

    x = _t(p).requires_grad_()
    sd = nn.signed_distance_to_set(x, _t(ref), _t(normals))
    sd.sum().backward()
    g = x.grad.numpy()

    def f(pp):
        return jnp.sum(jnn.signed_distance_to_set(pp, jnp.asarray(ref), jnp.asarray(normals)))

    np.testing.assert_allclose(g, np.asarray(jax.grad(f)(jnp.asarray(p))), atol=1e-12, rtol=0)
    eps = 1e-6
    for i in range(2):
        for k in range(3):
            dp = np.zeros((2, 3))
            dp[i, k] = eps
            fd = (
                nn.signed_distance_to_set(_t(p + dp), _t(ref), _t(normals)).sum()
                - nn.signed_distance_to_set(_t(p - dp), _t(ref), _t(normals)).sum()
            ) / (2 * eps)
            np.testing.assert_allclose(g[i, k], float(fd), atol=1e-4)
