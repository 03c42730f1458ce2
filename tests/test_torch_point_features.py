"""`losses/point_features.py` against the JAX package's
(bm2f_tpu/losses/point_features.py) on seeded masks.

- `sample_mask_points`: within 1e-6 of JAX's (the same four corner rows and
  weights, summed in another order: a few f32 ulps of |logits| <= ~4).
- `get_uncertain_point_coords_with_randomness`: the same candidate and
  random points on both sides (JAX's own draws from its key, injected into
  the port's `uncertain_point_coords`): the picks are bitwise JAX's, in
  JAX's order, also on a mask of tied logits, where `jax.lax.top_k` takes
  the lower index first. The port's own draws come from a
  `torch.Generator`: the same generator seed gives the same points.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bm2f_tpu.losses import point_features as jax_pf
from bm2f_tpu_torch.losses import point_features as pf

SAMPLE_ATOL = 1e-6


def _jax_draws(key, N, num_points, oversample_ratio, importance_sample_ratio):
    """The candidate and random points JAX's function draws from `key`."""
    r1, r2 = jax.random.split(key)
    n_cand = int(num_points * oversample_ratio)
    n_rand = num_points - int(importance_sample_ratio * num_points)
    cand = jax.random.uniform(r1, (N, n_cand, 2), jnp.float32)
    rand = jax.random.uniform(r2, (N, n_rand, 2), jnp.float32)
    return np.array(cand), np.array(rand)


@pytest.mark.parametrize("hw", [(7, 9), (16, 16), (33, 21)])
def test_sample_mask_points_matches_jax(rng, hw):
    masks = rng.randn(3, *hw).astype(np.float32) * 2
    coords = rng.rand(3, 50, 2).astype(np.float32) * 1.2 - 0.1  # some outside
    ref = np.asarray(jax_pf.sample_mask_points(jnp.asarray(masks), jnp.asarray(coords)))
    ours = pf.sample_mask_points(torch.from_numpy(masks), torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=SAMPLE_ATOL)


@pytest.mark.parametrize("case", ["random", "tied", "all_random_points"])
def test_uncertain_points_are_jax_picks(rng, case):
    N, num_points, ratio = 4, 24, 0.75
    if case == "tied":
        # whole blocks of equal |logit|: the top-k order rests on the indices
        logits = np.where(rng.rand(N, 12, 12) < 0.5, 0.25, -0.25).astype(np.float32)
        logits[:, :, :6] = 0.0
    else:
        logits = rng.randn(N, 12, 12).astype(np.float32)
    if case == "all_random_points":
        ratio = 0.0
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jax_pf.get_uncertain_point_coords_with_randomness(
        key, jnp.asarray(logits), num_points, 3.0, ratio))
    cand, rand = _jax_draws(key, N, num_points, 3.0, ratio)
    ours = pf.uncertain_point_coords(torch.from_numpy(logits), torch.from_numpy(cand),
                                     torch.from_numpy(rand), num_points, ratio).numpy()
    assert ours.shape == ref.shape == (N, num_points, 2)
    np.testing.assert_array_equal(ours, ref)


def test_tied_picks_keep_index_order(rng):
    """On all-equal logits every candidate ties: the picks are the first
    candidates in order, as `jax.lax.top_k` returns them."""
    logits = torch.zeros(2, 8, 8)
    cand = torch.from_numpy(rng.rand(2, 30, 2).astype(np.float32))
    rand = torch.from_numpy(rng.rand(2, 3, 2).astype(np.float32))
    got = pf.uncertain_point_coords(logits, cand, rand, 10, 0.75)
    assert torch.equal(got[:, :7], cand[:, :7])
    assert torch.equal(got[:, 7:], rand)


def test_generator_draws_are_seeded(rng):
    logits = torch.from_numpy(rng.randn(3, 10, 10).astype(np.float32))
    a, b = (pf.get_uncertain_point_coords_with_randomness(
        torch.Generator().manual_seed(3), logits, 16) for _ in range(2))
    assert a.shape == (3, 16, 2) and torch.equal(a, b)
    assert ((a >= 0) & (a < 1)).all()
    # the candidates' picks come first, then the fresh points
    gen = torch.Generator().manual_seed(3)
    cand = torch.rand((3, 48, 2), generator=gen)
    rand = torch.rand((3, 4, 2), generator=gen)
    assert torch.equal(a, pf.uncertain_point_coords(logits, cand, rand, 16))
