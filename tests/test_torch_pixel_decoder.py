"""The port's deformable-attention module and MSDeformAttn pixel decoder
against the JAX package's (`impl="im2col"`), with shared random weights
(the zero-init deformable projections replaced, so that sampling is not on
a fixed grid). Tolerance rtol 1e-4 / atol 1e-5 for the module (f32, sums in
another order); the 2-layer pixel decoder, which compounds convolutions,
GroupNorm and two encoder layers, uses the full-model tolerance rtol 1e-3 /
atol 1.5e-3 (tests/test_full_model_golden.py:58-63)."""

import numpy as np
import torch

import jax

from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.models.pixel_decoder import MSDeformAttnModule as JaxModule
from bm2f_tpu.models.pixel_decoder import MSDeformAttnPixelDecoder as JaxPixelDecoder
from bm2f_tpu.models.pixel_decoder import encoder_reference_points as jax_refs
from bm2f_tpu.models.resnet import RESNET_FEATURE_CHANNELS, RESNET_FEATURE_STRIDES
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.models.pixel_decoder import (
    MSDeformAttnModule,
    MSDeformAttnPixelDecoder,
    encoder_reference_points,
)
from torch_port_utils import randomize, submodule_state_dict

SMALL = {
    "model.pixel_decoder.conv_dim": 64,
    "model.pixel_decoder.mask_dim": 64,
    "model.pixel_decoder.transformer_enc_layers": 2,
    "model.pixel_decoder.transformer_dim_feedforward": 128,
    "model.pixel_decoder.deform_impl": "im2col",
}


def test_msdeform_module_matches_jax_im2col(rng):
    B, C, M, L, P = 2, 64, 2, 2, 4  # D = 32
    shapes = ((8, 8), (4, 4))
    S = sum(h * w for h, w in shapes)
    query = rng.randn(B, S, C).astype(np.float32)
    src = rng.randn(B, S, C).astype(np.float32)
    mod = JaxModule(C, L, M, P, impl="im2col")
    variables = mod.init(jax.random.PRNGKey(0), query, jax_refs(shapes), src, shapes)
    variables = randomize(variables, rng, 0.05)
    ref = mod.apply(variables, query, jax_refs(shapes), src, shapes)

    port = MSDeformAttnModule(C, L, M, P)
    port.load_state_dict({
        f"{m}.{'weight' if k == 'kernel' else k}":
            torch.from_numpy(np.asarray(v).T.copy() if k == "kernel" else np.asarray(v))
        for m, sub in variables["params"].items() for k, v in sub.items()
    })
    with torch.no_grad():
        ours = port(torch.from_numpy(query), encoder_reference_points(shapes),
                    torch.from_numpy(src), shapes).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_pixel_decoder_matches_jax(rng):
    B = 2
    feats = {f: rng.randn(B, 64 // s, 64 // s, RESNET_FEATURE_CHANNELS[f])
             .astype(np.float32) for f, s in RESNET_FEATURE_STRIDES.items()}
    jcfg = jax_get_config("coco_instance_r50", SMALL).model.pixel_decoder
    mod = JaxPixelDecoder(jcfg, RESNET_FEATURE_CHANNELS, RESNET_FEATURE_STRIDES)
    variables = mod.init(jax.random.PRNGKey(0), feats)
    variables = randomize(
        variables, rng, 0.05,
        only=lambda p: "sampling_offsets" in p or "attention_weights" in p)
    ref_mask, ref_top, ref_ms = mod.apply(variables, feats)

    cfg = get_config("coco_instance_r50", SMALL).model.pixel_decoder
    port = MSDeformAttnPixelDecoder(cfg, RESNET_FEATURE_CHANNELS, RESNET_FEATURE_STRIDES)
    port.load_state_dict(submodule_state_dict(
        variables, "sem_seg_head/pixel_decoder", "sem_seg_head.pixel_decoder"))
    with torch.no_grad():
        mask, top, ms = port({f: torch.from_numpy(x.transpose(0, 3, 1, 2)).contiguous()
                              for f, x in feats.items()})
    tol = dict(rtol=1e-3, atol=1.5e-3)
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    np.testing.assert_allclose(mask.numpy(), nchw(ref_mask), **tol)
    np.testing.assert_allclose(top.numpy(), nchw(ref_top), **tol)
    assert len(ms) == len(ref_ms) == 3
    for a, b in zip(ms, ref_ms):
        np.testing.assert_allclose(a.numpy(), nchw(b), **tol)
