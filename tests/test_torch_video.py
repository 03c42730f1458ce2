"""The port's video model against the JAX package's on shared weights: the
3D sine embeddings, the video decoder alone (with and without
`frame_valid`, the scanned `rounds` layout and the unrolled one), the whole
`VideoMaskFormer` on weights carried across by `jax_variables_to_state_dict`,
`inference_video`, and, in the port alone, a clip padded to its frame bucket
against the clip at its true length.

Sizes: depth-14 ResNet, conv/hidden/mask dim 64, FFN 128, 2 encoder layers,
3 decoder layers (one JAX round) or 2 (unrolled), 10 queries, 40 classes,
clips of 3 frames at 64x64 (the stride-4 masks 16x16).

Error model. Both frameworks compute in f32; they differ only in the order
of sums (convolutions, products, softmax) and in the libraries' sin/cos.
- The sine tables are built by the same f64 numpy code and rounded to f32
  once: equal bits. The frame-masked table adds an f32 sin/cos of the same
  f32 argument (the libraries' may differ by an ulp of 1, 1.2e-7) to the
  spatial table, and the sum (|x| <= 2) rounds on a grid 2.4e-7 apart:
  within 2 ulp of 2 (atol 4.8e-7).
- The decoder alone on unit-scale inputs: each output is a chain of ~10
  layers of sums of <= 64 * 768 terms, whose reassociation moves it by a
  few 1e-7 relative a layer; measured <= 3e-6 on values <= 5. Held at
  rtol 1e-4 / atol 1e-4.
- The whole model adds the backbone and the pixel decoder (tens of layers
  of 3x3 convolutions): the image model's tolerance, rtol 1e-3 / atol
  1.5e-3 (tests/test_torch_model.py); measured <= 1e-5.
- Padding a clip to its bucket changes the backbone's batch (other
  convolution blocking) and takes the temporal term from the f32 masked
  table instead of the f64 one: rtol 1e-4 / atol 1e-5, as the JAX
  package's own padding test holds its logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.models import position_encoding as jax_pe
from bm2f_tpu.video import build_video_model as jax_build_video_model
from bm2f_tpu.video.video_decoder import (
    VideoMultiScaleMaskedTransformerDecoder as JaxVideoDecoder,
)
from bm2f_tpu.video.video_maskformer import inference_video as jax_inference_video
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.models import position_encoding as pe
from bm2f_tpu_torch.tools.profile_request import perturb_deformable
from bm2f_tpu_torch.utils.convert_weights import jax_variables_to_state_dict
from bm2f_tpu_torch.video import build_video_model
from bm2f_tpu_torch.video.video_decoder import VideoMultiScaleMaskedTransformerDecoder
from bm2f_tpu_torch.video.video_maskformer import inference_video
from torch_port_utils import SMALL, randomize, submodule_state_dict, to_numpy_tree

K, T, S = 40, 3, 64
SIN_ATOL = 4.8e-7
DECODER_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = dict(rtol=1e-3, atol=1.5e-3)
PAD_TOL = dict(rtol=1e-4, atol=1e-5)
# dec_layers: 3 is one JAX round (`rounds`, scanned), 2 the unrolled layout
LAYOUTS = {"rounds": 3, "unrolled": 2}
# the second clip's last frame is padding
FRAME_VALID = np.array([[True, True, True], [True, True, False]])


def _over(layout):
    return {**SMALL, "model.decoder.dec_layers": LAYOUTS[layout]}


# -- 3D sine embeddings ------------------------------------------------------------


@pytest.mark.parametrize("t,h,w,f", [(3, 4, 6, 32), (5, 7, 3, 128)])
def test_sine_position_embedding_3d_matches_jax(t, h, w, f):
    ours = pe.sine_position_embedding_3d(t, h, w, f).numpy()
    ref = np.asarray(jax_pe.sine_position_embedding_3d(t, h, w, f))
    assert ours.shape == (t, h, w, 2 * f)
    np.testing.assert_array_equal(ours, ref)


def test_sine_position_embedding_3d_masked_matches_jax():
    fv = np.array([[True, True, True, False, False], [True] * 5, [True] + [False] * 4])
    ours = pe.sine_position_embedding_3d_masked(torch.from_numpy(fv), 4, 6, 32).numpy()
    ref = np.asarray(jax_pe.sine_position_embedding_3d_masked(jnp.asarray(fv), 4, 6, 32))
    assert ours.shape == (3, 5, 4, 6, 64)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=SIN_ATOL)
    # the valid frames of a padded clip: the true-length clip's embedding
    true = pe.sine_position_embedding_3d(3, 4, 6, 32).numpy()
    np.testing.assert_allclose(ours[0, :3], true, rtol=0, atol=SIN_ATOL)
    np.testing.assert_allclose(ours[1], pe.sine_position_embedding_3d(5, 4, 6, 32).numpy(),
                               rtol=0, atol=SIN_ATOL)


# -- the video decoder alone ---------------------------------------------------------


@pytest.fixture(scope="module", params=list(LAYOUTS))
def decoder_outputs(request):
    """JAX and port decoder outputs on unit-scale features and mask features
    that are one random vector per clip plus small noise, so that about half
    the queries block every key (the fallback rows), with and without
    `frame_valid`."""
    rng = np.random.RandomState(3)
    B, C = 2, 64
    ms = [rng.randn(B, T, h, w, C).astype(np.float32) for h, w in ((2, 2), (4, 4), (8, 8))]
    mf = (rng.randn(B, 1, 1, 1, C) + 0.01 * rng.randn(B, T, 16, 16, C)).astype(np.float32)
    cfg = jax_get_config("ytvis2019_video_r50", _over(request.param)).model.decoder
    jdec = JaxVideoDecoder(cfg, K)
    variables = to_numpy_tree(jax.jit(jdec.init)(
        jax.random.PRNGKey(1), [jnp.asarray(m) for m in ms], jnp.asarray(mf)))
    apply = jax.jit(jdec.apply)
    dec = VideoMultiScaleMaskedTransformerDecoder(cfg, K, [C] * 3)
    dec.load_state_dict(submodule_state_dict(variables, "sem_seg_head/predictor",
                                             "sem_seg_head.predictor"), strict=True)
    out = {}
    for name, fv in (("none", None), ("frame_valid", FRAME_VALID)):
        ref = to_numpy_tree(apply(variables, [jnp.asarray(m) for m in ms], jnp.asarray(mf),
                                  None if fv is None else jnp.asarray(fv)))
        with torch.no_grad():
            ours = dec([torch.from_numpy(m.transpose(0, 1, 4, 2, 3)) for m in ms],
                       torch.from_numpy(mf.transpose(0, 1, 4, 2, 3)),
                       None if fv is None else torch.from_numpy(fv))
        out[name] = (ref, {k: v.numpy() for k, v in ours.items()})
    # the all-blocked fallback is reached: some query's first attention mask
    # blocks every key
    membed = dec.mask_embed(dec.decoder_norm(dec.query_feat.weight)).detach().numpy()
    logits = np.einsum("qc,bc->bq", membed, mf[:, 0, 0, 0])
    assert (logits < 0).any() and (logits > 0).any()
    return out


@pytest.mark.parametrize("frames", ["none", "frame_valid"])
@pytest.mark.parametrize("key", ["pred_logits", "pred_masks", "aux_logits", "aux_masks"])
def test_video_decoder_matches_jax(decoder_outputs, frames, key):
    ref, ours = decoder_outputs[frames]
    assert ours[key].shape == ref[key].shape
    np.testing.assert_allclose(ours[key], ref[key], **DECODER_TOL)


# -- the whole model ------------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(LAYOUTS))
def model_outputs(request):
    """JAX and port VideoMaskFormer outputs on the same weights (the
    deformable projections perturbed) and normalized clips, with and without
    `frame_valid`; and the port model."""
    rng = np.random.RandomState(5)
    clips = rng.randn(2, T, S, S, 3).astype(np.float32)
    jcfg = jax_get_config("ytvis2019_video_r50", _over(request.param))
    jmodel = jax_build_video_model(jcfg)
    variables = to_numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(clips)))
    apply = jax.jit(jmodel.apply)
    variables = randomize(variables, rng, 0.05,
                          only=lambda p: "sampling_offsets" in p or "attention_weights" in p)
    cfg = get_config("ytvis2019_video_r50", _over(request.param))
    model = build_video_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables, cfg), strict=True)
    out = {}
    for name, fv in (("none", None), ("frame_valid", FRAME_VALID)):
        ref = to_numpy_tree(apply(variables, jnp.asarray(clips),
                                  None if fv is None else jnp.asarray(fv)))
        with torch.no_grad():
            ours = model(torch.from_numpy(clips), None if fv is None else torch.from_numpy(fv))
        out[name] = (ref, {k: v.numpy() for k, v in ours.items()})
    return out, model


@pytest.mark.parametrize("frames", ["none", "frame_valid"])
@pytest.mark.parametrize("key", ["pred_logits", "pred_masks", "aux_logits", "aux_masks",
                                 "mask_features"])
def test_video_model_matches_jax(model_outputs, frames, key):
    ref, ours = model_outputs[0][frames]
    assert ours[key].shape == ref[key].shape
    np.testing.assert_allclose(ours[key], ref[key], **MODEL_TOL)


def test_video_model_state_dict_is_the_image_models():
    """One `state_dict` fits the image and the video model, and a seed gives
    both the same weights."""
    from bm2f_tpu_torch.models import build_model

    cfg = get_config("ytvis2019_video_r50", _over("rounds"))
    a = build_video_model(cfg, device="cpu", seed=3).state_dict()
    b = build_model(cfg, device="cpu", seed=3).state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


# -- track inference --------------------------------------------------------------------------


def test_inference_video_matches_jax():
    """Shared logits with repeated rows, so that scores tie: the lower
    index first, as `jax.lax.top_k` orders them."""
    rng = np.random.RandomState(4)
    cls = (rng.randn(20, K + 1) * 3).astype(np.float32)
    cls[7] = cls[2]
    cls[11] = cls[2]
    masks = (rng.randn(20, T, 8, 12) * 2).astype(np.float32)
    ours = inference_video(torch.from_numpy(cls), torch.from_numpy(masks), num_classes=K,
                           topk=10)
    ref = jax_inference_video(jnp.asarray(cls), jnp.asarray(masks), num_classes=K, topk=10)
    np.testing.assert_array_equal(ours["labels"].numpy(), np.asarray(ref["labels"]))
    np.testing.assert_array_equal(ours["masks"].numpy(), np.asarray(ref["masks"]))
    np.testing.assert_allclose(ours["scores"].numpy(), np.asarray(ref["scores"]),
                               rtol=1e-6, atol=0)
    assert ours["masks"].dtype == torch.bool and ours["masks"].shape == (10, T, 8, 12)


# -- padding a clip to its frame bucket -------------------------------------------------------


def test_padded_clip_matches_true_length(model_outputs):
    """A 3-frame clip padded to the eval's 4-frame bucket with `frame_valid`
    gives the clip's own predictions on its frames, at every layer."""
    from bm2f_tpu_torch.eval_video import frame_bucket

    model = model_outputs[1]
    perturb_deformable(model)
    rng = np.random.RandomState(8)
    clip = torch.from_numpy(rng.randn(1, T, S, S, 3).astype(np.float32))
    Tp = frame_bucket(T)
    assert Tp == 4
    padded = torch.zeros(1, Tp, S, S, 3)
    padded[:, :T] = clip
    fv = torch.arange(Tp)[None] < T
    with torch.no_grad():
        true = model(clip)
        pad = model(padded, fv)
    for key in ("pred_logits", "aux_logits"):
        np.testing.assert_allclose(pad[key].numpy(), true[key].numpy(), **PAD_TOL)
    np.testing.assert_allclose(pad["pred_masks"][:, :, :T].numpy(),
                               true["pred_masks"].numpy(), **PAD_TOL)
    np.testing.assert_allclose(pad["aux_masks"][:, :, :, :T].numpy(),
                               true["aux_masks"].numpy(), **PAD_TOL)
