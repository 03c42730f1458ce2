"""bf16 serving of the port against the JAX package's `model.dtype =
"bfloat16"`, on the CPU.

- K1's plain version on a bf16 `value` against the JAX Pallas kernel in
  interpret mode (`out_head_major=True`: f32 out, as the model's path), rtol
  / atol 1e-5: both upcast the bf16 rows and compute in f32.
- The SMALL model (depth-14 ResNet, width 64, 2 encoder and 6 decoder
  layers, 64x64 images) on shared converted weights: the ResNet, the pixel
  decoder (`pixel_decoder_f32` both ways), the predictor and the whole
  model, each held against JAX in bf16 and in f32. Criterion, with
  e(a, b) = |a - b| / |b| (Frobenius norms):
      e(port_bf16, jax_f32) <= 2 e(jax_bf16, jax_f32) + ATOL_REL
  The factor 2 allows for the JAX CPU path rounding elsewhere: its
  deformable core is im2col, which rounds attention to bf16, where the port
  follows the Pallas path (the kernel's counterpart), and XLA on the CPU
  keeps f32 between fused bf16 ops. ATOL_REL is 1e-3 for the ResNet and the
  pixel decoder. For the predictor and the whole model it is 2e-2: the 0.5
  threshold of the attention mask turns bf16 rounding into flipped mask
  bits, so both frameworks' errors jump about 7-fold at decoder layer 4 of
  this random model and their size there depends on which bits flip.
  Readings (this CPU): ResNet e_port/e_jax 1.00, pixel decoder 1.17,
  predictor decoder layers 1-3 1.1-1.4 (0.9-1.04 with XLA's excess
  precision off), layers 4-5 and the outputs 1.5-3.2.
  The direct reading e(port_bf16, jax_bf16) is also held: readings ResNet
  1.0e-3, pixel decoder 6.5e-3, predictor and model 3-9e-2; limits 5e-3,
  2e-2, 0.15.
- A bf16 `Predictor` request on the CPU; gradients through a bf16 `value`
  and `Trainer` in bf16 (held against JAX in tests/test_torch_train_bf16.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.models import build_model as jax_build_model
from bm2f_tpu.models.pixel_decoder import MSDeformAttnPixelDecoder as JaxPixelDecoder
from bm2f_tpu.models.resnet import RESNET_FEATURE_CHANNELS, RESNET_FEATURE_STRIDES
from bm2f_tpu.models.resnet import ResNet as JaxResNet
from bm2f_tpu.models.transformer_decoder import (
    MultiScaleMaskedTransformerDecoder as JaxPredictor,
)
from bm2f_tpu.ops.deform_attn_pallas import ms_deform_attn_pallas
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.models import build_model
from bm2f_tpu_torch.models.layers import Linear, cast
from bm2f_tpu_torch.models.pixel_decoder import MSDeformAttnPixelDecoder
from bm2f_tpu_torch.models.resnet import ResNet
from bm2f_tpu_torch.models.transformer_decoder import MultiScaleMaskedTransformerDecoder
from bm2f_tpu_torch.ops import ms_deform_attn
from bm2f_tpu_torch.ops.deform_attn import ms_deform_attn_cuda, ms_deform_attn_plain
from bm2f_tpu_torch.predict import Predictor
from bm2f_tpu_torch.train.trainer import Trainer
from bm2f_tpu_torch.utils.convert_weights import jax_variables_to_state_dict
from torch_port_utils import SMALL, randomize, submodule_state_dict, to_numpy_tree

BF16 = {"model.dtype": "bfloat16", "model.pixel_decoder_f32": False}
BF16_PD_F32 = {"model.dtype": "bfloat16", "model.pixel_decoder_f32": True}
ATOL_REL = {"resnet": 1e-3, "pixel_decoder": 1e-3, "predictor": 2e-2, "model": 2e-2}
DIRECT_LIMIT = {"resnet": 5e-3, "pixel_decoder": 2e-2, "predictor": 0.15, "model": 0.15}
# tests/test_torch_deform_attn.py:20-23
CASES = [
    (1, 2, 32, 4, 20, ((8, 8), (4, 4))),
    (2, 2, 32, 3, 29, ((1, 7), (5, 1), (4, 6))),
]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def check_bf16(part, port, jax_bf16, jax_f32, tag=""):
    e_port, e_jax = rel(port, jax_f32), rel(jax_bf16, jax_f32)
    e_direct = rel(port, jax_bf16)
    msg = f"{part} {tag}: e_port {e_port:.3e} e_jax {e_jax:.3e} e_direct {e_direct:.3e}"
    assert e_port <= 2 * e_jax + ATOL_REL[part], msg
    assert e_direct <= DIRECT_LIMIT[part], msg


def nchw(a):
    return np.asarray(a, np.float32).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("case", CASES)
def test_k1_plain_on_bf16_value_matches_pallas(rng, case):
    B, M, D, P, Q, shapes = case
    S, L = sum(h * w for h, w in shapes), len(shapes)
    value = rng.randn(B, S, M, D).astype(np.float32)
    loc = (rng.rand(B, Q, M, L, P, 2) * 1.4 - 0.2).astype(np.float32)  # [-0.2, 1.2]
    attn = (rng.rand(B, Q, M, L, P) / (L * P)).astype(np.float32)
    ref = ms_deform_attn_pallas(jnp.asarray(value).astype(jnp.bfloat16), shapes,
                                jnp.asarray(loc), jnp.asarray(attn), q_tile=8,
                                interpret=True, out_head_major=True)
    ref = np.asarray(ref).transpose(0, 2, 1, 3).reshape(B, Q, M * D)
    args = (torch.from_numpy(value).to(torch.bfloat16), shapes,
            torch.from_numpy(loc), torch.from_numpy(attn))
    ours = ms_deform_attn_plain(*args)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)
    # the autograd Function takes the plain version on the CPU
    with torch.no_grad():
        np.testing.assert_array_equal(ms_deform_attn(*args).numpy(), ours.numpy())


def test_function_refuses_gradients_through_a_bf16_value(rng):
    """Since bf16 training (K2 on a bf16 `value`), the Function gives the
    gradients through a bf16 `value`: d_value in bf16, d_attn in f32 (the
    closed-form plain backward on the CPU; tests/test_torch_train_bf16.py
    holds them against JAX). What is still refused is cutting them: K1's
    wrapper, called outside the Function with grad mode on, raises."""
    shapes = ((4, 4),)
    value = torch.from_numpy(rng.randn(1, 16, 2, 32).astype(np.float32)).to(torch.bfloat16)
    value.requires_grad_(True)
    loc = torch.full((1, 5, 2, 1, 4, 2), 0.4)
    attn = torch.full((1, 5, 2, 1, 4), 0.25, requires_grad=True)
    out = ms_deform_attn(value, shapes, loc, attn)
    d_value, d_attn = torch.autograd.grad(out.sum(), (value, attn))
    assert d_value.dtype == torch.bfloat16 and d_attn.dtype == torch.float32
    assert d_value.abs().sum() > 0 and d_attn.abs().sum() > 0
    with pytest.raises(RuntimeError, match="cut the gradient"):
        ms_deform_attn_cuda(value, shapes, loc, attn)


def test_resnet14_bf16(rng):
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    variables = to_numpy_tree(JaxResNet(depth=14).init(jax.random.PRNGKey(0), x))
    ref = {dt: to_numpy_tree(JaxResNet(depth=14, dtype=dt).apply(variables, x))
           for dt in (jnp.float32, jnp.bfloat16)}
    port = ResNet(14, dtype=torch.bfloat16)
    port.load_state_dict(submodule_state_dict(variables, "backbone", "backbone"))
    with torch.no_grad():
        ours = port(torch.from_numpy(x.transpose(0, 3, 1, 2)).contiguous())
    assert set(ours) == set(ref[jnp.float32])
    for name, out in ours.items():
        assert out.dtype == torch.bfloat16
        check_bf16("resnet", out.float().numpy(), nchw(ref[jnp.bfloat16][name]),
                   nchw(ref[jnp.float32][name]), name)


@pytest.mark.parametrize("pixel_decoder_f32", [False, True])
def test_pixel_decoder_bf16(rng, pixel_decoder_f32):
    """The features a bf16 backbone hands over (bf16-representable), through
    the pixel decoder in bf16 or, with `pixel_decoder_f32`, in f32."""
    B = 2
    feats = {f: np.array(jnp.asarray(rng.randn(B, 64 // s, 64 // s,
                                                 RESNET_FEATURE_CHANNELS[f]))
                           .astype(jnp.bfloat16).astype(jnp.float32))
             for f, s in RESNET_FEATURE_STRIDES.items()}
    jcfg = jax_get_config("coco_instance_r50", SMALL).model.pixel_decoder
    variables = JaxPixelDecoder(jcfg, RESNET_FEATURE_CHANNELS, RESNET_FEATURE_STRIDES).init(
        jax.random.PRNGKey(0), feats)
    variables = randomize(to_numpy_tree(variables), rng, 0.05,
                          only=lambda p: "sampling_offsets" in p or "attention_weights" in p)
    ref = {dt: to_numpy_tree(JaxPixelDecoder(jcfg, RESNET_FEATURE_CHANNELS,
                                             RESNET_FEATURE_STRIDES, dtype=dt)
                             .apply(variables, feats))
           for dt in (jnp.float32, jnp.bfloat16)}
    dtype = torch.float32 if pixel_decoder_f32 else torch.bfloat16
    cfg = get_config("coco_instance_r50", SMALL).model.pixel_decoder
    port = MSDeformAttnPixelDecoder(cfg, RESNET_FEATURE_CHANNELS, RESNET_FEATURE_STRIDES,
                                    dtype=dtype)
    port.load_state_dict(submodule_state_dict(
        variables, "sem_seg_head/pixel_decoder", "sem_seg_head.pixel_decoder"))
    with torch.no_grad():
        mask, top, ms = port({f: torch.from_numpy(x.transpose(0, 3, 1, 2)).contiguous()
                              for f, x in feats.items()})
    outs = {"mask_features": mask, "top": top, **{f"ms{i}": m for i, m in enumerate(ms)}}
    refs = {dt: {"mask_features": r[0], "top": r[1], **{f"ms{i}": m for i, m in enumerate(r[2])}}
            for dt, r in ref.items()}
    for key, out in outs.items():
        assert out.dtype == dtype
        if pixel_decoder_f32:  # f32 throughout: the f32 parity tolerance
            np.testing.assert_allclose(out.numpy(), nchw(refs[jnp.float32][key]),
                                       rtol=1e-3, atol=1.5e-3, err_msg=key)
        else:
            check_bf16("pixel_decoder", out.float().numpy(), nchw(refs[jnp.bfloat16][key]),
                       nchw(refs[jnp.float32][key]), key)


def test_predictor_bf16(rng):
    jcfg = jax_get_config("coco_instance_r50", SMALL).model.decoder
    feats = [rng.randn(2, 64 // s, 64 // s, 64).astype(np.float32) for s in (32, 16, 8)]
    mask_features = rng.randn(2, 16, 16, 64).astype(np.float32)
    variables = to_numpy_tree(JaxPredictor(jcfg, 80).init(
        jax.random.PRNGKey(1), feats, mask_features))
    ref = {dt: to_numpy_tree(JaxPredictor(jcfg, 80, dtype=dt).apply(
        variables, feats, mask_features)) for dt in (jnp.float32, jnp.bfloat16)}
    cfg = get_config("coco_instance_r50", SMALL).model.decoder
    port = MultiScaleMaskedTransformerDecoder(cfg, 80, [64] * 3, dtype=torch.bfloat16)
    port.load_state_dict(submodule_state_dict(
        variables, "sem_seg_head/predictor", "sem_seg_head.predictor"))
    with torch.no_grad():
        ours = port([torch.from_numpy(nchw(f)).contiguous() for f in feats],
                    torch.from_numpy(nchw(mask_features)).contiguous())
    for key in ("pred_logits", "pred_masks", "aux_logits", "aux_masks"):
        assert ours[key].dtype == torch.float32
        check_bf16("predictor", ours[key].numpy(), ref[jnp.bfloat16][key],
                   ref[jnp.float32][key], key)
    # before any decoder layer, the two frameworks round alike
    np.testing.assert_allclose(ours["aux_logits"][0].numpy(), ref[jnp.bfloat16]["aux_logits"][0],
                               rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def models():
    """JAX's SMALL model in f32 and in bf16 both ways, and the port's in bf16
    both ways, on one set of converted weights."""
    rng = np.random.RandomState(5)
    images = rng.randn(2, 64, 64, 3).astype(np.float32)  # already normalized
    jcfg = jax_get_config("coco_instance_r50", SMALL)
    variables = to_numpy_tree(jax_build_model(jcfg).init(jax.random.PRNGKey(0),
                                                         jnp.asarray(images)))
    variables = randomize(
        variables, rng, 0.05,
        only=lambda p: "sampling_offsets" in p or "attention_weights" in p)
    out = {}
    for name, over in (("f32", {}), ("bf16", BF16), ("bf16_pd_f32", BF16_PD_F32)):
        out[f"jax_{name}"] = to_numpy_tree(jax_build_model(
            jax_get_config("coco_instance_r50", {**SMALL, **over})).apply(
                variables, jnp.asarray(images)))
        if name == "f32":
            continue
        cfg = get_config("coco_instance_r50", {**SMALL, **over})
        model = build_model(cfg, device="cpu")
        model.load_state_dict(jax_variables_to_state_dict(variables, cfg), strict=True)
        assert all(p.dtype == torch.float32 for p in model.state_dict().values())
        with torch.no_grad():
            out[f"port_{name}"] = {k: v for k, v in model(torch.from_numpy(images)).items()}
    return out


@pytest.mark.parametrize("name", ["bf16", "bf16_pd_f32"])
def test_whole_model_bf16(models, name):
    ours = models[f"port_{name}"]
    assert ours["mask_features"].dtype == (torch.bfloat16 if name == "bf16" else torch.float32)
    for key in ("pred_logits", "pred_masks", "aux_logits", "aux_masks"):
        assert ours[key].dtype == torch.float32
        assert ours[key].shape == models["jax_f32"][key].shape
        check_bf16("model", ours[key].numpy(), models[f"jax_{name}"][key],
                   models["jax_f32"][key], key)


def test_bf16_predictor_request_on_cpu():
    p = Predictor()
    p.setup("coco_instance_r50", device="cpu", seed=0, overrides={**SMALL, **BF16})
    assert p.model.backbone.dtype == torch.bfloat16
    image = np.random.RandomState(2).randint(0, 255, (50, 70, 3)).astype(np.uint8)
    out = p.predict(image)
    assert out["semantic"].shape == (50, 70, 80)
    assert out["semantic"].dtype == np.float32 and np.isfinite(out["semantic"]).all()
    inst = out["instances"]
    assert inst["masks"].shape == (100, 50, 70) and inst["masks"].dtype == bool
    assert inst["scores"].dtype == np.float32 and np.isfinite(inst["scores"]).all()
    seg_map, info = out["panoptic"]
    assert seg_map.shape == (50, 70) and seg_map.max() == len(info)


def test_kept_cast_copy_follows_the_parameter():
    """A served model keeps its weights cast once
    (`cast_weights_for_inference_`, which `Predictor.setup` calls): bf16 in
    the parts that compute in bf16, f32 in the pixel decoder with
    `pixel_decoder_f32`, f32 in every norm; `cast` hands a kept weight back
    as it is; the forward equals, bit for bit, the same model's that casts
    at every call; a load copies into the kept dtype. Under autograd an f32
    parameter is cast at every call, so gradients reach it."""
    images = torch.from_numpy(np.random.RandomState(3).randn(1, 64, 64, 3).astype(np.float32))
    for over in (BF16, BF16_PD_F32):
        cfg = get_config("coco_instance_r50", {**SMALL, **over})
        per_call = build_model(cfg, device="cpu")
        once = build_model(cfg, device="cpu").cast_weights_for_inference_()
        head = once.sem_seg_head
        pd_dtype = torch.float32 if cfg.model.pixel_decoder_f32 else torch.bfloat16
        for part, dtype in ((once.backbone, torch.bfloat16), (head.pixel_decoder, pd_dtype),
                            (head.predictor, torch.bfloat16)):
            for m in part.modules():
                norm = isinstance(m, (torch.nn.LayerNorm, torch.nn.GroupNorm))
                for t in [*m.parameters(recurse=False), *m.buffers(recurse=False)]:
                    assert t.dtype == (torch.float32 if norm else dtype), type(m)
        w = head.predictor.class_embed.weight
        assert cast(w, torch.bfloat16) is w
        with torch.no_grad():
            a, b = once(images), per_call(images)
            for key in ("pred_logits", "pred_masks"):
                torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
            once.load_state_dict(per_call.state_dict())
        assert head.predictor.class_embed.weight.dtype == torch.bfloat16
        torch.testing.assert_close(head.predictor.class_embed.weight,
                                   per_call.sem_seg_head.predictor.class_embed.weight
                                   .to(torch.bfloat16), rtol=0, atol=0)

    lin = Linear(4, 3)
    x = torch.randn(2, 4).to(torch.bfloat16)
    assert cast(lin.weight, torch.float32) is lin.weight
    lin(x).float().sum().backward()
    assert lin.weight.grad is not None and lin.weight.grad.dtype == torch.float32


def test_trainer_refuses_bf16():
    """Since bf16 training, `Trainer` takes model.dtype="bfloat16" (f32
    parameters, the weights cast at every call so that gradients reach
    them; tests/test_torch_train_bf16.py holds its step against JAX) and
    refuses only a dtype the model does not compute in."""
    trainer = Trainer(get_config("coco_instance_r50", {**SMALL, **BF16}), device="cpu")
    assert trainer.model.backbone.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    with pytest.raises(ValueError, match="model.dtype 'float16'"):
        Trainer(get_config("coco_instance_r50", {**SMALL, "model.dtype": "float16"}),
                device="cpu")
