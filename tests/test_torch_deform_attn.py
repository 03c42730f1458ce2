"""The port's multi-scale deformable attention (bm2f_tpu_torch.ops) against
the JAX package's: the plain version on the CPU against JAX's row-gather
(`impl="xla"`) and its Pallas kernel in interpret mode; the dispatch never
falls back to the plain version off the CPU; and, on a card, the CUDA kernel
against the plain version."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bm2f_tpu.ops import ms_deform_attn as jax_ms_deform_attn
from bm2f_tpu.ops.deform_attn_pallas import ms_deform_attn_pallas
from bm2f_tpu_torch.ops import ms_deform_attn
from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_cuda

# (B, M, D, P, Q, spatial shapes): tests/test_ops.py:181-193, then levels of
# height 1 and width 1 beside an ordinary one
CASES = [
    (1, 2, 32, 4, 20, ((8, 8), (4, 4))),
    (2, 2, 32, 3, 29, ((1, 7), (5, 1), (4, 6))),
]


def _inputs(rng, B, M, D, P, Q, shapes):
    S, L = sum(h * w for h, w in shapes), len(shapes)
    value = rng.randn(B, S, M, D).astype(np.float32)
    loc = (rng.rand(B, Q, M, L, P, 2) * 1.4 - 0.2).astype(np.float32)  # [-0.2, 1.2]
    attn = (rng.rand(B, Q, M, L, P) / (L * P)).astype(np.float32)
    return value, loc, attn


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_xla_and_pallas(rng, case):
    *dims, shapes = case
    value, loc, attn = _inputs(rng, *dims, shapes)
    ours = ms_deform_attn(torch.from_numpy(value), shapes,
                          torch.from_numpy(loc), torch.from_numpy(attn)).numpy()
    ref_xla = jax_ms_deform_attn(jnp.asarray(value), shapes, jnp.asarray(loc),
                                 jnp.asarray(attn), impl="xla")
    ref_pallas = ms_deform_attn_pallas(jnp.asarray(value), shapes, jnp.asarray(loc),
                                       jnp.asarray(attn), q_tile=8, interpret=True)
    # f32, sums of <= 4*L*P terms in another order
    np.testing.assert_allclose(ours, np.asarray(ref_xla), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours, np.asarray(ref_pallas), rtol=1e-5, atol=1e-5)


def test_off_cpu_tensors_never_take_the_plain_version():
    """A tensor that does not lie on the CPU goes to the kernel wrapper, which
    raises for anything but contiguous f32 CUDA tensors; nothing falls back
    to the plain version, and no launch is counted."""
    shapes = ((4, 4),)
    value = torch.empty(1, 16, 2, 32, device="meta")
    loc = torch.empty(1, 5, 2, 1, 4, 2, device="meta")
    attn = torch.empty(1, 5, 2, 1, 4, device="meta")
    before = ms_deform_attn_cuda.launches
    with pytest.raises(ValueError, match="must lie on"):
        ms_deform_attn(value, shapes, loc, attn)
    assert ms_deform_attn_cuda.launches == before


def test_spatial_shapes_must_cover_value(rng):
    value, loc, attn = _inputs(rng, 1, 2, 32, 4, 5, ((4, 4),))
    with pytest.raises(ValueError, match="sum to"):
        ms_deform_attn(torch.from_numpy(value), ((4, 5),),
                       torch.from_numpy(loc), torch.from_numpy(attn))
