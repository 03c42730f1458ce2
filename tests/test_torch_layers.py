"""The port's building blocks against the JAX package's on shared numpy
inputs and weights: resizing, the sine position embedding, multi-head
attention with an additive bias, and the depth-14 ResNet. Tolerance rtol
1e-4 / atol 1e-5 (f32, another summation order; tests/test_ops.py:176-178)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bm2f_tpu.models.layers import MultiHeadAttention as JaxMHA
from bm2f_tpu.models.position_encoding import sine_position_embedding_2d as jax_pe
from bm2f_tpu.models.resnet import ResNet as JaxResNet
from bm2f_tpu.ops import resize_bilinear as jax_bilinear
from bm2f_tpu.ops import resize_nearest as jax_nearest
from bm2f_tpu_torch.models.layers import MultiHeadAttention
from bm2f_tpu_torch.models.position_encoding import sine_position_embedding_2d
from bm2f_tpu_torch.models.resnet import ResNet
from bm2f_tpu_torch.ops import resize_bilinear, resize_nearest
from torch_port_utils import randomize, submodule_state_dict

RTOL, ATOL = 1e-4, 1e-5


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize(
    "in_hw,out_hw",
    [((8, 8), (16, 16)), ((13, 9), (32, 40)), ((32, 48), (7, 11)), ((5, 5), (5, 5))],
)
def test_resize_matches_jax(rng, mode, in_hw, out_hw):
    x = rng.randn(2, 3, *in_hw).astype(np.float32)  # NCHW
    ours = {"bilinear": resize_bilinear, "nearest": resize_nearest}[mode](
        torch.from_numpy(x), *out_hw).numpy()
    ref = {"bilinear": jax_bilinear, "nearest": jax_nearest}[mode](
        jnp.asarray(x.transpose(0, 2, 3, 1)), *out_hw)
    np.testing.assert_allclose(ours, np.asarray(ref).transpose(0, 3, 1, 2),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("h,w,f", [(25, 25, 128), (7, 12, 32), (1, 5, 16)])
def test_sine_position_embedding_matches_jax(h, w, f):
    ours = sine_position_embedding_2d(h, w, f).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_pe(h, w, f)), rtol=RTOL, atol=ATOL)


def test_multi_head_attention_with_bias_matches_jax(rng):
    B, Nq, Nk, C, H = 2, 7, 19, 64, 8
    q, k, v = (rng.randn(B, n, C).astype(np.float32) for n in (Nq, Nk, Nk))
    bias = np.where(rng.rand(B, 1, Nq, Nk) < 0.3, -1e9, 0.0).astype(np.float32)
    mod = JaxMHA(H)
    variables = mod.init(jax.random.PRNGKey(0), q, k, v, bias)
    variables = randomize(variables, rng, 0.2)
    ref = mod.apply(variables, q, k, v, bias)

    port = MultiHeadAttention(C, H)
    p = variables["params"]
    port.load_state_dict({
        "in_proj_weight": torch.from_numpy(np.asarray(p["in_proj_weight"]).T.copy()),
        "in_proj_bias": torch.from_numpy(np.asarray(p["in_proj_bias"])),
        "out_proj.weight": torch.from_numpy(np.asarray(p["out_proj"]["kernel"]).T.copy()),
        "out_proj.bias": torch.from_numpy(np.asarray(p["out_proj"]["bias"])),
    })
    with torch.no_grad():
        ours = port(*(torch.from_numpy(a) for a in (q, k, v, bias))).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=RTOL, atol=ATOL)


# The depth-14 ResNet: each stage's output carries the rounding of the
# convolutions before it, and the two frameworks sum each output (up to
# 3 x 3 x 256 = 2304 f32 products) in another order (oneDNN against XLA's
# CPU convolutions, whose order differs between machines). Reordering such a
# sum moves it by about sqrt(2304) = 48 f32 ulps (eps 1.2e-7) of the layer's
# activation scale, ~6e-6 of it, and the next layers carry that along. So the
# error of an element is absolute and follows its stage's largest activation,
# not its own value: atol = RESNET_ATOL_OF_MAX x max |ref| per stage, rtol
# as above. Readings on a CPU: max error / max |ref| 3.3e-7 (res2) to 7.5e-7
# (res5), max |ref| 8.8 to 25.5.
RESNET_ATOL_OF_MAX = 1e-5


def _resnet14(rng):
    """x, the JAX ResNet's variables (random folded FrozenBN too: its init is
    the identity) and its outputs."""
    x = rng.randn(1, 64, 64, 3).astype(np.float32)
    mod = JaxResNet(depth=14)
    variables = mod.init(jax.random.PRNGKey(0), x)
    variables = {"params": variables["params"],
                 "frozen": randomize(variables["frozen"], rng, 0.1)}
    variables["frozen"] = jax.tree.map(lambda a: a + 1.0 if a.ndim else a,
                                       variables["frozen"])
    return x, variables, mod.apply(variables, x)


def _assert_stages_close(ours, ref):
    assert set(ours) == set(ref)
    for name in ref:
        want = np.asarray(ref[name]).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(ours[name].numpy(), want, rtol=RTOL,
                                   atol=RESNET_ATOL_OF_MAX * np.abs(want).max(),
                                   err_msg=name)


def _port_resnet14(variables, x, scale_weight=None):
    port = ResNet(14)
    state = submodule_state_dict(variables, "backbone", "backbone")
    if scale_weight is not None:
        name, factor = scale_weight
        state[name] = state[name] * factor
    port.load_state_dict(state)
    with torch.no_grad():
        return port(torch.from_numpy(x.transpose(0, 3, 1, 2)).contiguous())


def test_resnet14_matches_jax(rng):
    x, variables, ref = _resnet14(rng)
    _assert_stages_close(_port_resnet14(variables, x), ref)


def test_resnet14_bound_catches_a_wrong_weight(rng):
    """The per-stage bound is loose enough for the machines' rounding and
    still refuses a port whose last convolution's weight is off by 0.1 %."""
    x, variables, ref = _resnet14(rng)
    name = "res5.0.conv3.weight"
    assert name in ResNet(14).state_dict()
    with pytest.raises(AssertionError, match="res5"):
        _assert_stages_close(_port_resnet14(variables, x, (name, 1.001)), ref)
