"""The slice as a whole: the port's MaskFormer against the JAX package's on
shared weights (carried across by `jax_variables_to_state_dict`), the three
inference modes on shared logits, and one `Predictor` request on the CPU.

Model size: depth-14 ResNet, conv/hidden/mask dim 64, FFN 128, 2 encoder
layers, 6 decoder layers (two stacked rounds in the JAX tree, so the
unstacking is exercised), 10 queries, on (2, 64, 64, 3). Tolerance rtol 1e-3
/ atol 1.5e-3, as tests/test_full_model_golden.py:58-63."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.evaluation.panoptic_post import relabel_panoptic as jax_relabel
from bm2f_tpu.models import build_model as jax_build_model
from bm2f_tpu.models import maskformer as jax_mf
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.evaluation.panoptic_post import relabel_panoptic
from bm2f_tpu_torch.models import build_model
from bm2f_tpu_torch.models import maskformer as mf
from bm2f_tpu_torch.predict import Predictor
from bm2f_tpu_torch.utils.convert_weights import jax_variables_to_state_dict
from torch_port_utils import SMALL, randomize, to_numpy_tree

TOL = dict(rtol=1e-3, atol=1.5e-3)
K = 80


@pytest.fixture(scope="module")
def outputs():
    rng = np.random.RandomState(5)
    images = rng.randn(2, 64, 64, 3).astype(np.float32)  # already normalized
    jcfg = jax_get_config("coco_instance_r50", SMALL)
    jmodel = jax_build_model(jcfg)
    variables = to_numpy_tree(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images)))
    variables = randomize(
        variables, rng, 0.05,
        only=lambda p: "sampling_offsets" in p or "attention_weights" in p)
    ref = to_numpy_tree(jmodel.apply(variables, jnp.asarray(images)))

    cfg = get_config("coco_instance_r50", SMALL)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables, cfg), strict=True)
    with torch.no_grad():
        ours = {k: v.numpy() for k, v in model(torch.from_numpy(images)).items()}
    return ref, ours


@pytest.mark.parametrize("key", ["pred_logits", "pred_masks", "aux_logits",
                                 "aux_masks", "mask_features"])
def test_forward_matches_jax(outputs, key):
    ref, ours = outputs
    assert ours[key].shape == ref[key].shape
    np.testing.assert_allclose(ours[key], ref[key], **TOL)


@pytest.fixture(scope="module")
def shared_logits():
    """Mostly-disjoint block masks (random masks all fail the 0.8 overlap
    test and make the panoptic comparison vacuous); queries 48+ predict
    empty masks."""
    rng = np.random.RandomState(11)
    mask_cls = (rng.randn(100, K + 1) * 3).astype(np.float32)
    mask_pred = np.full((100, 24, 32), -4.0, np.float32)
    for q in range(48):
        by, bx = divmod(q, 8)
        mask_pred[q, by * 4:(by + 1) * 4, bx * 4:(bx + 1) * 4] = 4.0
    mask_pred += rng.randn(*mask_pred.shape).astype(np.float32) * 0.1
    return mask_cls, mask_pred


def test_semantic_inference_matches_jax(shared_logits):
    c, p = shared_logits
    ours = mf.semantic_inference(torch.from_numpy(c), torch.from_numpy(p)).numpy()
    ref = np.asarray(jax_mf.semantic_inference(jnp.asarray(c), jnp.asarray(p)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


def test_instance_inference_matches_jax(shared_logits):
    c, p = shared_logits
    thing = tuple(k < 40 for k in range(K))
    ours = mf.instance_inference(torch.from_numpy(c), torch.from_numpy(p),
                                 num_classes=K, topk=100, thing_mask=thing)
    ref = jax_mf.instance_inference(jnp.asarray(c), jnp.asarray(p),
                                    num_classes=K, topk=100, thing_mask=thing)
    for key in ("labels", "masks", "valid"):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]))
    np.testing.assert_allclose(ours["scores"].numpy(), np.asarray(ref["scores"]),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("thr", [0.015, 0.05])
def test_panoptic_inference_matches_jax(shared_logits, thr):
    c, p = shared_logits
    kw = dict(num_classes=K, thing_mask=tuple(k < 40 for k in range(K)),
              object_mask_threshold=thr, overlap_threshold=0.8)
    ours = mf.panoptic_inference(torch.from_numpy(c), torch.from_numpy(p), **kw)
    ref = to_numpy_tree(jax_mf.panoptic_inference(jnp.asarray(c), jnp.asarray(p), **kw))
    for key in ref:
        np.testing.assert_array_equal(ours[key].numpy(), ref[key], err_msg=key)
    seg, info = relabel_panoptic({k: v.numpy() for k, v in ours.items()})
    seg_ref, info_ref = jax_relabel(ref)
    assert len(info) > 5, "test vacuous: too few segments"
    assert info == info_ref
    np.testing.assert_array_equal(seg, seg_ref)


def test_sem_seg_postprocess_matches_jax(rng):
    x = rng.randn(5, 32, 48).astype(np.float32)
    ours = mf.sem_seg_postprocess(torch.from_numpy(x), (32, 48), (30, 41), (60, 82))
    ref = jax_mf.sem_seg_postprocess(jnp.asarray(x), (32, 48), (30, 41), (60, 82))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_predictor_request_on_cpu():
    p = Predictor()
    p.setup("coco_instance_r50", device="cpu", seed=0)
    image = np.random.RandomState(2).randint(0, 255, (50, 70, 3)).astype(np.uint8)
    out = p.predict(image)
    assert out["semantic"].shape == (50, 70, K)
    assert np.isfinite(out["semantic"]).all()
    inst = out["instances"]
    assert inst["masks"].shape == (100, 50, 70) and inst["masks"].dtype == bool
    assert inst["scores"].shape == inst["labels"].shape == (100,)
    assert np.isfinite(inst["scores"]).all()
    seg_map, info = out["panoptic"]
    assert seg_map.shape == (50, 70)
    assert seg_map.max() == len(info)
