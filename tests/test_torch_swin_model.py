"""The SMALL Swin Mask2Former of the port against the JAX package's on shared
weights: the forward in f32 and in bf16, a served bf16 model whose weights
were cast once, a `Predictor` request on the CPU, and the weights from a
detectron2-layout Swin state dict.

Model: a `coco_instance_swin_t` preset with `SMALL_SWIN` (embed 32, heads
(1, 2, 4, 8), depths (2, 2, 3, 2), window 7; SMALL's head: width 64, 2
encoder and 6 decoder layers, 10 queries) on (2, 64, 96, 3) normalized
images, the deformable projections and every bias drawn from N(0, 0.05).

Error model.
- f32: the image model's tolerance, rtol 1e-3 / atol 1.5e-3
  (tests/test_torch_model.py); the backbone alone is held at 1e-4 in
  tests/test_torch_swin.py. Measured here <= 3e-6.
- bf16: as tests/test_torch_bf16.py, relative to JAX's own bf16 error,
  e(a, b) = |a - b| / |b| (Frobenius):
      e(port_bf16, jax_f32) <= 2 e(jax_bf16, jax_f32) + ATOL_REL,
  ATOL_REL 1e-3 for the backbone, 2e-2 for the whole model (the decoder's
  0.5 mask threshold turns bf16 rounding into flipped mask bits). Directly,
  e(port_bf16, jax_bf16) <= 0.15 for the model; for the backbone, whose bf16
  error grows over its blocks (JAX's own reads 5.1e-3 from f32 at res2 and
  1.0e-2 at res5), two bf16 paths that round apart may sit up to twice
  that from each other: e(port_bf16, jax_bf16) <= 2 e(jax_bf16, jax_f32) +
  ATOL_REL (read 5.2e-3 at res2, 1.2e-2 at res5). XLA on the CPU keeps f32
  between fused bf16 ops where the port rounds each op.
- Weights: a dict written in detectron2's layout is the same bits through
  either converter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.models import build_model as jax_build_model
from bm2f_tpu.models.swin import SwinTransformer as JaxSwin
from bm2f_tpu.utils.convert_weights import convert_checkpoint
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.models import build_model
from bm2f_tpu_torch.models.layers import LayerNorm
from bm2f_tpu_torch.models.maskformer import MaskFormer
from bm2f_tpu_torch.models.swin import SwinTransformer, relative_position_index
from bm2f_tpu_torch.predict import Predictor
from bm2f_tpu_torch.utils.convert_weights import (
    jax_variables_to_state_dict,
    load_d2_state_dict,
)
from torch_port_utils import SMALL_SWIN, randomize, submodule_state_dict, to_numpy_tree

PRESET = "coco_instance_swin_t"
BF16 = {"model.dtype": "bfloat16", "model.pixel_decoder_f32": False}
MODEL_TOL = dict(rtol=1e-3, atol=1.5e-3)
ATOL_REL = {"backbone": 1e-3, "model": 2e-2}
DIRECT_LIMIT_MODEL = 0.15
KEYS = ["pred_logits", "pred_masks", "aux_logits", "aux_masks", "mask_features"]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def shared():
    """Images, the JAX variables (f32) and the JAX outputs in f32 and bf16."""
    rng = np.random.RandomState(5)
    images = rng.randn(2, 64, 96, 3).astype(np.float32)
    out = {}
    for tag, over in (("f32", {}), ("bf16", BF16)):
        jmodel = jax_build_model(jax_get_config(PRESET, {**SMALL_SWIN, **over}))
        if tag == "f32":
            variables = to_numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                           jnp.asarray(images)))
            variables = randomize(variables, rng, 0.05, only=lambda p: (
                "sampling_offsets" in p or "attention_weights" in p or p.endswith("bias")))
        out[tag] = {k: np.asarray(v, np.float32) for k, v in to_numpy_tree(
            jax.jit(jmodel.apply)(variables, jnp.asarray(images))).items()}
    return images, variables, out


def _port(over, variables):
    cfg = get_config(PRESET, {**SMALL_SWIN, **over})
    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables, cfg), strict=True)
    return model


@pytest.fixture(scope="module")
def port_outputs(shared):
    images, variables, _ = shared
    out = {}
    for tag, over in (("f32", {}), ("bf16", BF16)):
        with torch.no_grad():
            got = _port(over, variables)(torch.from_numpy(images))
        out[tag] = {k: v.float().numpy() for k, v in got.items()}
    return out


@pytest.mark.parametrize("key", KEYS)
def test_swin_model_matches_jax(shared, port_outputs, key):
    ref, ours = shared[2]["f32"][key], port_outputs["f32"][key]
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, **MODEL_TOL)


@pytest.mark.parametrize("key", ["pred_logits", "pred_masks"])
def test_swin_model_bf16_matches_jax(shared, port_outputs, key):
    jax_f32, jax_bf16 = shared[2]["f32"][key], shared[2]["bf16"][key]
    port = port_outputs["bf16"][key]
    e_port, e_jax, e_direct = rel(port, jax_f32), rel(jax_bf16, jax_f32), rel(port, jax_bf16)
    msg = f"e_port {e_port:.3e} e_jax {e_jax:.3e} e_direct {e_direct:.3e}"
    assert e_jax > 0, "the JAX bf16 path computed in f32"
    assert e_port <= 2 * e_jax + ATOL_REL["model"], msg
    assert e_direct <= DIRECT_LIMIT_MODEL, msg


def test_swin_backbone_bf16_matches_jax(shared):
    """The backbone alone in bf16: input cast once, LayerNorm statistics in
    f32, the softmax in f32, everything else in bf16."""
    images, variables, _ = shared
    kw = dict(embed_dim=32, depths=(2, 2, 3, 2), num_heads=(1, 2, 4, 8), window=7)
    bb_vars = {"params": variables["params"]["backbone"]}
    ref = {}
    for dt in (jnp.float32, jnp.bfloat16):
        ref[dt] = to_numpy_tree(jax.jit(JaxSwin(**kw, dtype=dt).apply)(
            bb_vars, jnp.asarray(images)))
    port = SwinTransformer(**kw, dtype=torch.bfloat16)
    port.load_state_dict(submodule_state_dict(bb_vars, "backbone", "backbone"), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(images).permute(0, 3, 1, 2))
    for name in ("res2", "res3", "res4", "res5"):
        assert got[name].dtype == torch.bfloat16
        p = got[name].float().numpy().transpose(0, 2, 3, 1)
        f32 = np.asarray(ref[jnp.float32][name], np.float32)
        b16 = np.asarray(ref[jnp.bfloat16][name], np.float32)
        e_port, e_jax, e_direct = rel(p, f32), rel(b16, f32), rel(p, b16)
        msg = f"{name}: e_port {e_port:.3e} e_jax {e_jax:.3e} e_direct {e_direct:.3e}"
        assert e_port <= 2 * e_jax + ATOL_REL["backbone"], msg
        assert e_direct <= 2 * e_jax + ATOL_REL["backbone"], msg


def test_served_bf16_weights_cast_once(shared):
    """`cast_weights_for_inference_` casts the Swin backbone's weights and
    tables to bf16 once (LayerNorms keep f32), and the served model gives
    the bits of the model that casts them at every call."""
    images, variables, _ = shared
    model = _port(BF16, variables)
    x = torch.from_numpy(images)
    with torch.no_grad():
        want = model(x)
        model.cast_weights_for_inference_()
        got = model(x)
    for name, p in model.backbone.named_parameters():
        owner = model.backbone.get_submodule(name.rpartition(".")[0])
        assert p.dtype == (torch.float32 if isinstance(owner, LayerNorm) else torch.bfloat16), name
    for k in ("pred_logits", "pred_masks"):
        assert torch.equal(got[k], want[k]), k


def test_predictor_request_on_swin():
    p = Predictor()
    p.setup(PRESET, device="cpu", seed=0, overrides=SMALL_SWIN)
    image = np.random.RandomState(2).randint(0, 255, (50, 70, 3)).astype(np.uint8)
    out = p.predict(image)
    assert out["semantic"].shape == (50, 70, 80) and np.isfinite(out["semantic"]).all()
    assert out["instances"]["masks"].shape == (100, 50, 70)
    assert out["panoptic"][0].shape == (50, 70)


# -- weights in detectron2's layout ----------------------------------------------------


@pytest.fixture(scope="module")
def d2_swin(shared):
    """A detectron2-layout state dict of the SMALL Swin model, written from
    the seeded JAX tree, with upstream's `attn.relative_position_index`
    buffers beside each block's table."""
    _, variables, _ = shared
    cfg = get_config(PRESET, SMALL_SWIN)
    sd = {k: v.numpy() for k, v in jax_variables_to_state_dict(variables, cfg).items()}
    for k in [k for k in sd if k.endswith(".attn.relative_position_bias_table")]:
        window = (int(np.sqrt(sd[k].shape[0])) + 1) // 2
        sd[k.replace("bias_table", "index")] = relative_position_index(window)
    return sd, variables, cfg


def test_d2_swin_dict_is_the_jax_tree(d2_swin):
    """The JAX package's own converter turns the dict back into the tree."""
    sd, variables, cfg = d2_swin
    got = convert_checkpoint(sd, backbone="swin", swin_depths=(2, 2, 3, 2),
                             dec_layers=cfg.model.decoder.dec_layers,
                             enc_layers=cfg.model.pixel_decoder.transformer_enc_layers)
    want = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    got_flat = dict(jax.tree_util.tree_flatten_with_path(got["params"])[0])
    assert len(got_flat) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got_flat[path]), leaf, err_msg=str(path))


def test_d2_swin_load_equals_jax_tree_and_loads_strictly(d2_swin):
    sd, variables, cfg = d2_swin
    from_d2 = load_d2_state_dict(sd)
    from_jax = jax_variables_to_state_dict(variables, cfg)
    assert sorted(from_d2) == sorted(from_jax)
    for k in from_jax:
        assert torch.equal(from_d2[k], from_jax[k]), k
    # LayerNorms named `.norm` keep `.weight`: no FrozenBN fold in Swin
    assert "backbone.patch_embed.norm.weight" in from_d2
    assert "backbone.layers.0.downsample.norm.weight" in from_d2
    assert not any(k.startswith("backbone.") and k.endswith(".scale") for k in from_d2)
    for weights in (from_d2, from_jax):
        MaskFormer(cfg.model).load_state_dict(weights, strict=True)


def test_d2_swin_buffers_checked_and_dropped(d2_swin):
    sd = dict(d2_swin[0])
    sd["backbone.layers.0.blocks.1.attn_mask"] = np.zeros((4, 49, 49), np.float32)
    out = load_d2_state_dict(sd)
    assert not any("relative_position_index" in k or "attn_mask" in k for k in out)
    key = "backbone.layers.1.blocks.0.attn.relative_position_index"
    sd[key] = sd[key][::-1].copy()
    with pytest.raises(ValueError, match="window-7 index"):
        load_d2_state_dict(sd)
