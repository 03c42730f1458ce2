"""The SMALL Swin clip model of the port against the JAX package's video
model on shared weights: a clip at its true length and one padded to its
frame bucket with `frame_valid`, and, in the port, the padded clip against
the true-length one.

Model: `ytvis2019_video_swin_t` with `SMALL_SWIN` (embed 32, heads
(1, 2, 4, 8), depths (2, 2, 3, 2), window 7, SMALL's head) and 3 decoder
layers (one JAX round), clips of 3 frames at 64x64. The B*T frames go
through the Swin backbone as one batch.

Error model: as tests/test_torch_video.py. The whole model against JAX at
the image model's rtol 1e-3 / atol 1.5e-3 (measured <= 1e-5); the padded
clip against its true length at rtol 1e-4 / atol 1e-5 (another backbone
batch and the f32 masked temporal table), as the JAX package's own padding
test holds its logits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.video import build_video_model as jax_build_video_model
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.eval_video import frame_bucket
from bm2f_tpu_torch.models.swin import SwinTransformer
from bm2f_tpu_torch.utils.convert_weights import jax_variables_to_state_dict
from bm2f_tpu_torch.video import build_video_model
from torch_port_utils import SMALL_SWIN, randomize, to_numpy_tree

PRESET = "ytvis2019_video_swin_t"
OVER = {**SMALL_SWIN, "model.decoder.dec_layers": 3}
T, S = 3, 64
MODEL_TOL = dict(rtol=1e-3, atol=1.5e-3)
PAD_TOL = dict(rtol=1e-4, atol=1e-5)
KEYS = ["pred_logits", "pred_masks", "aux_logits", "aux_masks", "mask_features"]


@pytest.fixture(scope="module")
def outputs():
    """JAX and port outputs on one clip of 3 frames, at its true length and
    padded to the 4-frame bucket with `frame_valid`."""
    rng = np.random.RandomState(6)
    clip = rng.randn(1, T, S, S, 3).astype(np.float32)
    Tp = frame_bucket(T)
    padded = np.zeros((1, Tp, S, S, 3), np.float32)
    padded[:, :T] = clip
    fv = np.arange(Tp)[None] < T
    jmodel = jax_build_video_model(jax_get_config(PRESET, OVER))
    variables = to_numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(clip)))
    variables = randomize(variables, rng, 0.05, only=lambda p: (
        "sampling_offsets" in p or "attention_weights" in p or p.endswith("bias")))
    apply = jax.jit(jmodel.apply)
    cfg = get_config(PRESET, OVER)
    model = build_video_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables, cfg), strict=True)
    assert isinstance(model.backbone, SwinTransformer)
    out = {}
    for name, x, mask in (("true", clip, None), ("padded", padded, fv)):
        ref = to_numpy_tree(apply(variables, jnp.asarray(x),
                                  None if mask is None else jnp.asarray(mask)))
        with torch.no_grad():
            ours = model(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
        out[name] = (ref, {k: v.numpy() for k, v in ours.items()})
    return out


@pytest.mark.parametrize("clip", ["true", "padded"])
@pytest.mark.parametrize("key", KEYS)
def test_swin_clip_model_matches_jax(outputs, clip, key):
    ref, ours = outputs[clip]
    assert ours[key].shape == ref[key].shape
    np.testing.assert_allclose(ours[key], ref[key], **MODEL_TOL)


def test_swin_padded_clip_matches_true_length(outputs):
    true, pad = outputs["true"][1], outputs["padded"][1]
    for key in ("pred_logits", "aux_logits"):
        np.testing.assert_allclose(pad[key], true[key], **PAD_TOL)
    np.testing.assert_allclose(pad["pred_masks"][:, :, :T], true["pred_masks"], **PAD_TOL)
    np.testing.assert_allclose(pad["aux_masks"][:, :, :, :T], true["aux_masks"], **PAD_TOL)
