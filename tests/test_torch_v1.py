"""The MaskFormer-v1 architectures of the port against the JAX package's
(`bm2f_tpu/models/transformer.py`, `maskformer_v1.py`, `BasePixelDecoder`),
each class alone and the whole `MaskFormer` for all six pixel-decoder x
decoder pairs, on shared weights carried by the port's converter.

Sizes: width 32 (GroupNorm's 32 groups), FFN 64, 4 heads, 1-2 layers, 8
queries, 5 classes, the depth-14 ResNet, inputs from numpy seeds. Error
model: both sides compute in f32; the port's sums run in another order
(oneDNN against XLA), each product of K terms off by ~sqrt(K) 6e-8 of its
scale, carried through LayerNorm/GroupNorm (which renormalise) and at most
a few layers: a module alone reads ~1e-6 of its output's scale, so it is
held at rtol 1e-4 / atol 1e-5 x max|ref|; the whole model (ResNet, FPN,
decoder) at the full-model tolerance rtol 1e-3 / atol 1.5e-3
(tests/test_full_model_golden.py:58-63)."""

import jax
import numpy as np
import pytest
import torch

from bm2f_tpu.config import DecoderConfig as JaxDecoderConfig
from bm2f_tpu.config import PixelDecoderConfig as JaxPixelDecoderConfig
from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.models import build_model as jax_build_model
from bm2f_tpu.models import maskformer_v1 as jax_v1
from bm2f_tpu.models import transformer as jax_tr
from bm2f_tpu.models.pixel_decoder import BasePixelDecoder as JaxBasePixelDecoder
from bm2f_tpu_torch.config import DecoderConfig, PixelDecoderConfig, get_config
from bm2f_tpu_torch.models import build_model
from bm2f_tpu_torch.models import maskformer_v1 as v1
from bm2f_tpu_torch.models import transformer as tr
from bm2f_tpu_torch.models.layers import init_parameters
from bm2f_tpu_torch.models.pixel_decoder import BasePixelDecoder
from bm2f_tpu_torch.utils.convert_weights import (
    jax_head_variables_to_state_dict,
    jax_variables_to_state_dict,
)
from bm2f_tpu_torch.video import build_video_model
from torch_port_utils import randomize, submodule_state_dict, to_numpy_tree

MODULE_TOL = 1e-4
MODEL_TOL = dict(rtol=1e-3, atol=1.5e-3)
C, FFN, HEADS = 32, 64, 4
CHANNELS = {"res2": 16, "res3": 24, "res4": 40, "res5": 48}
STRIDES = {"res2": 4, "res3": 8, "res4": 16, "res5": 32}
# the v1 model of the whole-model tests (`coco_instance_r50` overrides)
TINY_V1 = {
    "model.backbone.resnet.depth": 14,
    "model.num_classes": 5,
    "model.pixel_decoder.conv_dim": C,
    "model.pixel_decoder.mask_dim": C,
    "model.pixel_decoder.transformer_enc_layers": 2,
    "model.pixel_decoder.transformer_nheads": HEADS,
    "model.pixel_decoder.transformer_dim_feedforward": FFN,
    "model.pixel_decoder.deform_impl": "im2col",
    "model.decoder.hidden_dim": C,
    "model.decoder.mask_dim": C,
    "model.decoder.nheads": HEADS,
    "model.decoder.dim_feedforward": FFN,
    "model.decoder.dec_layers": 2,
    "model.decoder.num_queries": 8,
}
PAIRS = [(pd, dec) for pd in ("msdeform", "transformer_fpn", "fpn")
         for dec in ("multi_scale_masked", "standard")]


def _close(ours, ref, tol=MODULE_TOL):
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol * 0.1 * np.abs(ref).max())


def _init(mod, *args, seed=0):
    """A JAX module's variables with every leaf redrawn from N(0, 0.2), so
    that zero-init biases and unit norms take part."""
    variables = to_numpy_tree(jax.jit(mod.init)(jax.random.PRNGKey(0), *args))
    return randomize(variables, np.random.RandomState(seed), 0.2)


def _features(rng, B=2, size=64):
    return {f: rng.randn(B, size // s, size // s, CHANNELS[f]).astype(np.float32)
            for f, s in STRIDES.items()}


def _nchw(feats):
    return {k: torch.from_numpy(v).permute(0, 3, 1, 2).contiguous() for k, v in feats.items()}


@pytest.mark.parametrize("pre_norm", [False, True])
def test_encoder_layer_and_stack_match_jax(pre_norm):
    rng = np.random.RandomState(1)
    src = rng.randn(2, 20, C).astype(np.float32)
    pos = rng.randn(1, 20, C).astype(np.float32)
    layer = jax_tr.TransformerEncoderLayer(C, HEADS, FFN, pre_norm)
    variables = _init(layer, src, pos)
    port = tr.TransformerEncoderLayer(C, HEADS, FFN, pre_norm)
    port.load_state_dict(submodule_state_dict(
        variables, "sem_seg_head/pixel_decoder/transformer/layer_0",
        "sem_seg_head.pixel_decoder.transformer.encoder.layers.0"))
    with torch.no_grad():
        _close(port(torch.from_numpy(src), torch.from_numpy(pos)).numpy(),
               jax.jit(layer.apply)(variables, src, pos))

    stack = jax_tr.TransformerEncoder(2, C, HEADS, FFN, pre_norm)
    variables = _init(stack, src, pos, seed=2)
    port = tr.TransformerEncoder(2, C, HEADS, FFN, pre_norm)
    assert (port.norm is not None) == pre_norm  # the final norm only pre-norm
    port.load_state_dict(submodule_state_dict(
        variables, "sem_seg_head/pixel_decoder/transformer",
        "sem_seg_head.pixel_decoder.transformer.encoder"), strict=True)
    with torch.no_grad():
        _close(port(torch.from_numpy(src), torch.from_numpy(pos)).numpy(),
               jax.jit(stack.apply)(variables, src, pos))


@pytest.mark.parametrize("pre_norm", [False, True])
def test_decoder_layer_and_stack_match_jax(pre_norm):
    rng = np.random.RandomState(3)
    tgt = rng.randn(2, 8, C).astype(np.float32)
    memory = rng.randn(2, 30, C).astype(np.float32)
    pos = rng.randn(1, 30, C).astype(np.float32)
    qpos = rng.randn(2, 8, C).astype(np.float32)
    args = (tgt, memory, pos, qpos)
    targs = [torch.from_numpy(a) for a in args]
    layer = jax_tr.TransformerDecoderLayer(C, HEADS, FFN, pre_norm)
    variables = _init(layer, *args)
    port = tr.TransformerDecoderLayer(C, HEADS, FFN, pre_norm)
    port.load_state_dict(submodule_state_dict(
        variables, "sem_seg_head/predictor/decoder/layer_0",
        "sem_seg_head.predictor.transformer.decoder.layers.0"))
    with torch.no_grad():
        _close(port(*targs).numpy(), jax.jit(layer.apply)(variables, *args))

    stack = jax_tr.TransformerDecoder(2, C, HEADS, FFN, pre_norm)
    variables = _init(stack, *args, seed=4)
    port = tr.TransformerDecoder(2, C, HEADS, FFN, pre_norm)
    port.load_state_dict(submodule_state_dict(
        variables, "sem_seg_head/predictor/decoder",
        "sem_seg_head.predictor.transformer.decoder"), strict=True)
    with torch.no_grad():
        ours = port(*targs).numpy()
    assert ours.shape == (2, 2, 8, C)  # every layer, through the shared norm
    _close(ours, jax.jit(stack.apply)(variables, *args))


@pytest.mark.parametrize("norm", ["group_norm", ""])
def test_base_pixel_decoder_matches_jax(norm):
    """Nearest top-down, GroupNorm after every conv (a bias only without a
    norm), a 3x3 mask-features conv, the three coarsest outputs."""
    cfg = JaxPixelDecoderConfig(conv_dim=C, mask_dim=C, norm=norm)
    feats = _features(np.random.RandomState(5))
    mod = JaxBasePixelDecoder(cfg, CHANNELS, STRIDES)
    variables = _init(mod, feats)
    ref = jax.jit(mod.apply)(variables, feats)
    port = BasePixelDecoder(PixelDecoderConfig(conv_dim=C, mask_dim=C, norm=norm),
                            CHANNELS, STRIDES)
    port.load_state_dict(submodule_state_dict(
        variables, "sem_seg_head/pixel_decoder", "sem_seg_head.pixel_decoder",
        pixel_decoder="fpn"), strict=True)
    assert port.layer_4.weight.shape[-1] == 3 and port.mask_features.weight.shape[-1] == 3
    assert (port.layer_1.bias is not None) == (norm == "")
    with torch.no_grad():
        mf, tf, ms = port(_nchw(feats))
    assert ref[1] is None and tf is None
    _close(mf.permute(0, 2, 3, 1).numpy(), ref[0])
    assert [f.shape[-1] for f in ms] == [2, 4, 8]
    for o, r in zip(ms, ref[2]):
        _close(o.permute(0, 2, 3, 1).numpy(), r)


@pytest.mark.parametrize("enc_layers", [2, 0])
def test_transformer_encoder_pixel_decoder_matches_jax(enc_layers):
    """The encoder is post-norm, 0 layers means 6 (`or 6`), and its output
    comes back as the transformer feature."""
    cfg = dict(conv_dim=C, mask_dim=C, transformer_enc_layers=enc_layers,
               transformer_nheads=HEADS, transformer_dim_feedforward=FFN)
    feats = _features(np.random.RandomState(6))
    mod = jax_v1.TransformerEncoderPixelDecoder(JaxPixelDecoderConfig(**cfg), CHANNELS, STRIDES)
    variables = _init(mod, feats)
    ref = jax.jit(mod.apply)(variables, feats)
    port = v1.TransformerEncoderPixelDecoder(PixelDecoderConfig(**cfg), CHANNELS, STRIDES)
    assert len(port.transformer.encoder.layers) == (enc_layers or 6)
    assert port.transformer.encoder.norm is None
    port.load_state_dict(submodule_state_dict(
        variables, "sem_seg_head/pixel_decoder", "sem_seg_head.pixel_decoder",
        pixel_decoder="transformer_fpn"), strict=True)
    with torch.no_grad():
        mf, tf, ms = port(_nchw(feats))
    _close(mf.permute(0, 2, 3, 1).numpy(), ref[0])
    _close(tf.permute(0, 2, 3, 1).numpy(), ref[1])
    for o, r in zip(ms, ref[2]):
        _close(o.permute(0, 2, 3, 1).numpy(), r)


@pytest.mark.parametrize("case", ["proj", "no_proj", "pre_norm", "no_classes"])
def test_standard_decoder_matches_jax(case):
    """`input_proj` only when the width differs (or is enforced), masks of
    every layer split into pred and aux, no logits without classification,
    `num_queries` overriding the config's."""
    rng = np.random.RandomState(7)
    Ci = C if case == "no_proj" else 48
    x = rng.randn(2, 4, 6, Ci).astype(np.float32)
    mf = rng.randn(2, 16, 24, C).astype(np.float32)
    kw = dict(hidden_dim=C, num_queries=8, nheads=HEADS, dim_feedforward=FFN,
              dec_layers=3, mask_dim=C, pre_norm=case == "pre_norm")
    cls, nq = case != "no_classes", 5 if case == "no_classes" else 0
    mod = jax_v1.StandardTransformerDecoder(JaxDecoderConfig(**kw), 5,
                                            mask_classification=cls, num_queries=nq)
    variables = _init(mod, x, mf)
    ref = to_numpy_tree(jax.jit(mod.apply)(variables, x, mf))
    port = v1.StandardTransformerDecoder(DecoderConfig(**kw), 5, Ci,
                                         mask_classification=cls, num_queries=nq)
    assert (port.input_proj is None) == (case == "no_proj")
    port.load_state_dict(submodule_state_dict(
        variables, "sem_seg_head/predictor", "sem_seg_head.predictor"), strict=True)
    with torch.no_grad():
        ours = port(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(mf).permute(0, 3, 1, 2))
    assert set(ours) == set(ref)
    assert ours["pred_masks"].shape == (2, nq or 8, 16, 24)
    assert ours["aux_masks"].shape[0] == 2
    for k in ref:
        _close(ours[k].numpy(), ref[k])


def test_per_pixel_baseline_head_matches_jax():
    cfg = dict(conv_dim=C, mask_dim=C)
    feats = _features(np.random.RandomState(8))
    mod = jax_v1.PerPixelBaselineHead(JaxPixelDecoderConfig(**cfg), 5, CHANNELS, STRIDES)
    variables = _init(mod, feats)
    ref = jax.jit(mod.apply)(variables, feats)
    port = v1.PerPixelBaselineHead(PixelDecoderConfig(**cfg), 5, CHANNELS, STRIDES)
    port.load_state_dict(jax_head_variables_to_state_dict(variables, port), strict=True)
    with torch.no_grad():
        ours = port(_nchw(feats)).numpy()
    assert ours.shape == (2, 16, 16, 5)
    _close(ours, ref)


@pytest.mark.parametrize("deep_supervision", [True, False])
def test_per_pixel_baseline_plus_head_matches_jax(deep_supervision):
    """Queries are the classes; per-pixel logits (B, H4, W4, K) and every
    earlier layer's, transposed as the JAX head does."""
    pcfg = dict(conv_dim=C, mask_dim=C, transformer_enc_layers=1, transformer_nheads=HEADS,
                transformer_dim_feedforward=FFN)
    dcfg = dict(hidden_dim=C, mask_dim=C, nheads=HEADS, dim_feedforward=FFN, dec_layers=3,
                num_queries=999)
    feats = _features(np.random.RandomState(9))
    mod = jax_v1.PerPixelBaselinePlusHead(
        JaxPixelDecoderConfig(**pcfg), JaxDecoderConfig(**dcfg), 7, CHANNELS, STRIDES,
        deep_supervision=deep_supervision)
    variables = _init(mod, feats)
    ref = jax.jit(mod.apply)(variables, feats)
    port = v1.PerPixelBaselinePlusHead(
        PixelDecoderConfig(**pcfg), DecoderConfig(**dcfg), 7, CHANNELS, STRIDES,
        deep_supervision=deep_supervision)
    assert port.predictor.query_embed.weight.shape[0] == 7
    port.load_state_dict(jax_head_variables_to_state_dict(variables, port), strict=True)
    with torch.no_grad():
        ours = port(_nchw(feats))
    if deep_supervision:
        assert ours[0].shape == (2, 16, 16, 7) and ours[1].shape == (2, 2, 16, 16, 7)
        _close(ours[0].numpy(), ref[0])
        _close(ours[1].numpy(), ref[1])
    else:
        _close(ours.numpy(), ref)


@pytest.fixture(scope="module", params=PAIRS, ids=["-".join(p) for p in PAIRS])
def model_pair(request):
    pd, dec = request.param
    over = {**TINY_V1, "model.pixel_decoder.name": pd, "model.decoder.name": dec}
    rng = np.random.RandomState(10)
    images = rng.randn(2, 64, 96, 3).astype(np.float32)  # already normalized
    jmodel = jax_build_model(jax_get_config("coco_instance_r50", over))
    variables = to_numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0), images))
    variables = randomize(
        variables, rng, 0.05,
        only=lambda p: "sampling_offsets" in p or "attention_weights" in p)
    ref = to_numpy_tree(jax.jit(jmodel.apply)(variables, images))
    cfg = get_config("coco_instance_r50", over)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables, cfg), strict=True)
    with torch.no_grad():
        ours = {k: v.numpy() for k, v in model(torch.from_numpy(images)).items()}
    return request.param, ref, ours


def test_maskformer_matches_jax_for_every_pair(model_pair):
    """`build_model` builds the six pairs the JAX `MaskFormerHead` builds;
    "standard" reads res5 when the pixel decoder has no transformer
    feature; aux outputs in the criterion's (L, B, Q, ...) layout."""
    (pd, dec), ref, ours = model_pair
    assert set(ours) == set(ref)
    # the masked decoder predicts from its raw queries too: dec_layers + 1 heads
    heads = TINY_V1["model.decoder.dec_layers"] + (dec == "multi_scale_masked")
    assert ours["aux_logits"].shape == (heads - 1, 2, 8, 6)
    for k in ref:
        assert ours[k].shape == ref[k].shape, k
        np.testing.assert_allclose(ours[k], ref[k], **MODEL_TOL, err_msg=k)


def test_unknown_names_and_video_pairs_raise():
    for key, name in (("model.pixel_decoder.name", "deformable_fpn"),
                      ("model.decoder.name", "masked")):
        with pytest.raises(ValueError, match=name):
            build_model(get_config("coco_instance_r50", {**TINY_V1, key: name}), device="cpu")
    # the JAX video head builds msdeform + the video decoder whatever the config names
    for key, name in (("model.pixel_decoder.name", "fpn"),
                      ("model.pixel_decoder.name", "transformer_fpn"),
                      ("model.decoder.name", "standard")):
        with pytest.raises(ValueError, match=name):
            build_video_model(get_config("ytvis2019_video_r50", {key: name}), device="cpu")


def test_v1_init_follows_the_jax_initialisers():
    """c2-xavier `input_proj` convs (bound sqrt(3 / fan_in)), N(0, 1)
    `query_embed`, zero biases, unit norms."""
    over = {**TINY_V1, "model.pixel_decoder.name": "transformer_fpn",
            "model.decoder.name": "standard", "model.decoder.num_queries": 200}
    model = build_model(get_config("coco_instance_r50", over), device="cpu", seed=3)
    head = model.sem_seg_head
    for conv in (head.pixel_decoder.input_proj, head.predictor.input_proj):
        if conv is None:
            continue
        bound = (3.0 / conv.weight[0].numel()) ** 0.5
        assert conv.weight.abs().max() <= bound and conv.weight.abs().max() > 0.9 * bound
        assert not conv.bias.any()
    q = head.predictor.query_embed.weight
    assert abs(q.std().item() - 1.0) < 0.1 and abs(q.mean().item()) < 0.1
    layer = head.predictor.transformer.decoder.layers[0]
    assert (layer.norm1.weight == 1).all() and not layer.linear1.bias.any()
    b = (6.0 / (C + FFN)) ** 0.5
    assert layer.linear1.weight.abs().max() <= b


def test_per_pixel_head_init():
    head = v1.PerPixelBaselineHead(PixelDecoderConfig(conv_dim=C, mask_dim=C), 5,
                                   CHANNELS, STRIDES)
    init_parameters(head, torch.Generator().manual_seed(0))
    bound = (3.0 / C) ** 0.5
    assert head.predictor.weight.abs().max() <= bound
    assert head.predictor.weight.abs().max() > 0.5 * bound
