"""Gradients of the port's multi-scale deformable attention against the JAX
package's: `MSDeformAttnFunction` (through the `ms_deform_attn` dispatch) and
the closed-form `ms_deform_attn_bwd_plain` on the CPU against `jax.grad` of
`bm2f_tpu.ops.ms_deform_attn(impl="im2col")`, which the JAX suite holds
against its Pallas VJP (tests/test_ops.py:196-222); `gradcheck` in float64;
and the guard that keeps K1 from cutting a gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bm2f_tpu.ops import ms_deform_attn as jax_ms_deform_attn
from bm2f_tpu_torch.ops import ms_deform_attn
from bm2f_tpu_torch.ops.deform_attn import (
    ms_deform_attn_bwd_plain,
    ms_deform_attn_cuda,
    ms_deform_attn_plain,
)

# (B, M, D, P, Q, spatial shapes, attn scale): the shapes of
# tests/test_ops.py:202-208, then the edge shapes of tests/test_torch_cuda.py
# (levels of height 1 and width 1, a 1x1 level, D over one warp, Q not a
# power of two)
CASES = [
    (2, 2, 32, 3, 29, ((6, 7), (3, 4)), 1 / 6),
    (1, 2, 32, 4, 20, ((8, 8), (4, 4)), 1 / 8),
    (2, 2, 32, 3, 29, ((1, 7), (5, 1), (4, 6)), 1 / 9),
    (1, 8, 64, 4, 333, ((1, 1), (3, 9), (16, 12)), 1 / 12),
]
# tests/test_ops.py:176-178
TOL = {"value": dict(rtol=1e-4, atol=1e-5),
       "loc": dict(rtol=1e-3, atol=1e-4),
       "attn": dict(rtol=1e-4, atol=1e-5)}


def _inputs(case, seed=0, dtype=np.float32):
    B, M, D, P, Q, shapes, scale = case
    rng = np.random.RandomState(seed)
    S, L = sum(h * w for h, w in shapes), len(shapes)
    value = rng.randn(B, S, M, D).astype(dtype)
    loc = (rng.rand(B, Q, M, L, P, 2) * 1.4 - 0.2).astype(dtype)  # [-0.2, 1.2]
    attn = (rng.rand(B, Q, M, L, P) * scale).astype(dtype)
    return shapes, value, loc, attn


@pytest.fixture(scope="module", params=CASES, ids=range(len(CASES)))
def case_and_jax_grads(request):
    """Inputs and jax.grad of sum(sin(0.3 * out)) through the im2col path."""
    shapes, value, loc, attn = _inputs(request.param)

    def loss(v, l, a):
        o = jax_ms_deform_attn(v, shapes, l, a, impl="im2col")
        return jnp.sum(jnp.sin(o * 0.3))

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn))
    ref = dict(zip(("value", "loc", "attn"), (np.asarray(g) for g in grads)))
    return (shapes, value, loc, attn), ref


def test_function_grads_match_jax(case_and_jax_grads):
    (shapes, value, loc, attn), ref = case_and_jax_grads
    tv, tl, ta = (torch.from_numpy(x).requires_grad_(True) for x in (value, loc, attn))
    out = ms_deform_attn(tv, shapes, tl, ta)
    assert type(out.grad_fn).__name__ == "MSDeformAttnFunctionBackward"
    torch.sin(out * 0.3).sum().backward()
    for name, t in (("value", tv), ("loc", tl), ("attn", ta)):
        np.testing.assert_allclose(t.grad.numpy(), ref[name], err_msg=name, **TOL[name])


def test_closed_form_backward_matches_jax(case_and_jax_grads):
    (shapes, value, loc, attn), ref = case_and_jax_grads
    v, l, a = (torch.from_numpy(x) for x in (value, loc, attn))
    out = ms_deform_attn_plain(v, shapes, l, a)
    grads = ms_deform_attn_bwd_plain(v, shapes, l, a, 0.3 * torch.cos(out * 0.3))
    for name, g in zip(("value", "loc", "attn"), grads):
        np.testing.assert_allclose(g.numpy(), ref[name], err_msg=name, **TOL[name])


@pytest.mark.parametrize("case", CASES[1:3])
def test_function_passes_gradcheck_in_float64(case):
    """The plain Function in float64, at a narrow D and few queries (the
    plain versions take any D; the numerical Jacobian costs one forward per
    input element)."""
    B, M, _, P, _, shapes, scale = case
    shapes, *arrays = _inputs((B, M, 4, P, 5, shapes, scale), seed=2, dtype=np.float64)
    value, loc, attn = (torch.from_numpy(x).requires_grad_(True) for x in arrays)
    assert torch.autograd.gradcheck(
        lambda v, l, a: ms_deform_attn(v, shapes, l, a), (value, loc, attn))


def test_function_skips_gradients_not_asked_for():
    shapes, value, loc, attn = _inputs(CASES[1])
    tv = torch.from_numpy(value).requires_grad_(True)
    out = ms_deform_attn(tv, shapes, torch.from_numpy(loc), torch.from_numpy(attn))
    (g,) = torch.autograd.grad(out.sum(), (tv,))
    assert g.shape == tv.shape


def test_kernel_wrapper_refuses_to_cut_a_gradient():
    """Called outside the Function with grad mode on and an input that
    requires grad, K1's wrapper raises instead of returning an output with
    no grad_fn; no launch is counted."""
    shapes, value, loc, attn = _inputs(CASES[1])
    before = ms_deform_attn_cuda.launches
    with pytest.raises(RuntimeError, match="cut the gradient"):
        ms_deform_attn_cuda(torch.from_numpy(value).requires_grad_(True), shapes,
                            torch.from_numpy(loc), torch.from_numpy(attn))
    assert ms_deform_attn_cuda.launches == before
