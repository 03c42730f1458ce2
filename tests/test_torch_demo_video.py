"""The port's video demo (`bm2f_tpu_torch.demo_video`) against the root
`demo_video.py`'s computation.

1. Its tracks on a tiny clip against the JAX video model with the root's
   order (every query's masks resized to the padded size, cropped, then
   `inference_video`), on shared weights. Error model, as
   tests/test_torch_video.py's whole-model parity: outputs within
   FWD_EPS = 1.5e-3 + 1e-3 max|value|, so scores (softmax probabilities)
   within FWD_EPS, labels equal where the scores are apart, and a mask
   pixel may flip only where its resized logit lies within FWD_EPS of 0.
2. Selecting the tracks first and resizing only their masks gives the
   tracks of resizing all Q queries' masks first, bit for bit.
3. The entry point on the CPU writes one PNG per frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.models.maskformer import normalize_images as jax_normalize
from bm2f_tpu.ops import resize_bilinear as jax_resize
from bm2f_tpu.video import build_video_model as jax_build_video_model
from bm2f_tpu.video.video_maskformer import inference_video as jax_inference_video
from bm2f_tpu_torch import demo_video
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.models.maskformer import normalize_images
from bm2f_tpu_torch.ops import resize_bilinear
from bm2f_tpu_torch.video import build_video_model
from bm2f_tpu_torch.video.video_maskformer import inference_video
from bm2f_tpu_torch.utils.convert_weights import jax_variables_to_state_dict
from torch_port_utils import randomize, to_numpy_tree

T, H, W = 3, 50, 70  # padded to 64 x 96
TINY = {"model.backbone.resnet.depth": 14, "model.decoder.dec_layers": 2,
        "model.decoder.num_queries": 12, "model.pixel_decoder.transformer_enc_layers": 1,
        "model.test.topk_per_video": 5, "model.num_frames": T}


@pytest.fixture(scope="module")
def clip_and_models():
    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, (T, H, W, 3)).astype(np.uint8)
    clip = np.zeros((1, T, 64, 96, 3), np.float32)
    clip[0, :, :H, :W] = frames
    jcfg = jax_get_config("ytvis2019_video_r50", TINY)
    jmodel = jax_build_video_model(jcfg)
    variables = to_numpy_tree(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, T, 64, 64, 3))))
    variables = randomize(variables, rng, 0.05,
                          only=lambda p: "sampling_offsets" in p or "attention_weights" in p)
    cfg = get_config("ytvis2019_video_r50", TINY)
    model = build_video_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables, cfg), strict=True)
    return frames, clip, (jcfg, jmodel, variables), (cfg, model)


def test_tracks_match_the_root_order_in_jax(clip_and_models):
    _, clip, (jcfg, jmodel, variables), (cfg, model) = clip_and_models
    out = jax.jit(jmodel.apply)(variables, jax_normalize(jnp.asarray(clip), jcfg.model))
    masks4 = out["pred_masks"][0]  # (Q, T, h4, w4), resized as root demo_video.py:72-75
    full = jax.vmap(lambda m: jax_resize(m.transpose(1, 2, 0), 64, 96).transpose(2, 0, 1))(
        masks4.transpose(1, 0, 2, 3)).transpose(1, 0, 2, 3)[:, :, :H, :W]
    ref = to_numpy_tree(jax_inference_video(out["pred_logits"][0], full,
                                            num_classes=jcfg.model.num_classes,
                                            topk=jcfg.model.test.topk_per_video))
    ours = demo_video.clip_tracks(cfg, model, torch.from_numpy(clip), (H, W))
    with torch.no_grad():
        raw = model(normalize_images(torch.from_numpy(clip), cfg.model))
    eps = 1.5e-3 + 1e-3 * max(raw["pred_logits"].abs().max().item(),
                              raw["pred_masks"].abs().max().item())
    scores = ours["scores"].numpy()
    assert ours["masks"].shape == (5, T, H, W) and ours["masks"].dtype == torch.bool
    np.testing.assert_allclose(scores, ref["scores"], rtol=0, atol=eps)
    apart = np.ones(5, bool)  # a track whose score is within 2 eps of a neighbour may swap
    apart[:-1] &= np.diff(-scores) > 2 * eps
    apart[1:] &= np.diff(-scores) > 2 * eps
    assert apart.sum() >= 2
    np.testing.assert_array_equal(ours["labels"].numpy()[apart], ref["labels"][apart])
    sel = ours["masks"].numpy()[apart] != ref["masks"][apart]
    logits = resize_bilinear(raw["pred_masks"][0], 64, 96)[..., :H, :W]
    q = (torch.sort(torch.softmax(raw["pred_logits"][0], -1)[:, :-1].reshape(-1),
                    descending=True, stable=True).indices[:5] // cfg.model.num_classes)
    band = (logits[q].abs() <= eps).numpy()[apart]
    assert not (sel & ~band).any()


def test_selecting_first_equals_resizing_all_first(clip_and_models):
    _, clip, _, (cfg, model) = clip_and_models
    ours = demo_video.clip_tracks(cfg, model, torch.from_numpy(clip), (H, W))
    with torch.no_grad():
        out = model(normalize_images(torch.from_numpy(clip), cfg.model))
        full = resize_bilinear(out["pred_masks"][0], 64, 96)[..., :H, :W]
    ref = inference_video(out["pred_logits"][0], full, num_classes=cfg.model.num_classes,
                          topk=cfg.model.test.topk_per_video)
    for k in ("scores", "labels", "masks"):
        assert torch.equal(ours[k], ref[k]), k


def test_entry_point_writes_one_png_per_frame(clip_and_models, tmp_path):
    frames = clip_and_models[0]
    src = tmp_path / "frames"
    src.mkdir()
    for t, f in enumerate(frames):
        Image.fromarray(f).save(src / f"{t:05d}.png")
    res = demo_video.main(
        ["--input", str(src), "--output", str(tmp_path / "out"), "--device", "cpu",
         "--confidence", "0.0"]
        + [a for k, v in TINY.items() if k != "model.num_frames" for a in ("--set", f"{k}={v}")])
    assert res["frames"] == T and res["padded_hw"] == (64, 96) and res["tracks_kept"] == 5
    for path in res["written"]:
        with Image.open(path) as im:
            assert im.size == (W, H)
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        f"{t:05d}.png" for t in range(T)]
