"""Training the MaskFormer-v1 models through the port's `Trainer`, against
the JAX package: the optimizer's parameter groups (the backbone's LR
multiplier, no decay on norms and `query_embed`) for every v1 pair, and one
whole step of `transformer_fpn` + `standard` (forward, criterion on JAX's
own random points, backward, clip) against a JAX `value_and_grad` of the
same loss on shared weights; `fpn` + `multi_scale_masked` takes a step too.

Sizes as tests/test_torch_v1.py (width 32, 2 encoder and 2 decoder layers,
8 queries, the depth-14 ResNet) on (2, 64, 64, 3) with 4 targets an image.
Error model, as tests/test_torch_train.py's: the losses are sums of f32
terms in another order (rtol 1e-4); every gradient within 1e-3 of its
tensor's norm, the norm-relative error f32 backpropagation through a few
layers reaches (read ~1e-5 here)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.losses.criterion import set_criterion as jax_set_criterion
from bm2f_tpu.models import build_model as jax_build_model
from bm2f_tpu.models.maskformer import normalize_images as jax_normalize_images
from bm2f_tpu.train.trainer import criterion_config as jax_criterion_config
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.models import build_model
from bm2f_tpu_torch.train.trainer import Trainer, synthetic_batch
from bm2f_tpu_torch.utils.convert_weights import jax_tree_to_numpy, jax_variables_to_state_dict
from test_torch_train import check_param_groups
from test_torch_v1 import TINY_V1
from torch_port_utils import jax_criterion_points, to_numpy_tree

V1 = {**TINY_V1, "model.pixel_decoder.name": "transformer_fpn",
      "model.decoder.name": "standard"}
V1_PAIRS = [("fpn", "multi_scale_masked"), ("fpn", "standard"),
            ("transformer_fpn", "multi_scale_masked"), ("transformer_fpn", "standard")]


def _jax_variables(over):
    jcfg = jax_get_config("coco_instance_r50", over)
    jmodel = jax_build_model(jcfg)
    sample = jnp.zeros((1, 64, 64, 3), jnp.float32)
    return jcfg, jmodel, to_numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0), sample))


@pytest.mark.parametrize("pd,dec", V1_PAIRS)
def test_v1_param_groups_match_jax(pd, dec):
    """Every parameter's (LR multiplier, decayed) against the JAX path rule
    (bm2f_tpu/train/optim.py:23-42), tensor by tensor."""
    over = {**TINY_V1, "model.pixel_decoder.name": pd, "model.decoder.name": dec}
    _, _, variables = _jax_variables(over)
    cfg = get_config("coco_instance_r50", over)
    by_name = check_param_groups(variables, build_model(cfg, device="cpu"), cfg)
    if dec == "standard":
        assert not by_name["sem_seg_head.predictor.query_embed.weight"].decay
        assert not by_name["sem_seg_head.predictor.transformer.decoder.norm.weight"].decay
        if pd == "fpn":  # res5's 512 channels into the 32-wide decoder
            assert by_name["sem_seg_head.predictor.input_proj.weight"].decay
    assert not by_name["sem_seg_head.pixel_decoder.layer_4.norm.weight"].decay


@pytest.fixture(scope="module")
def v1_step():
    jcfg, jmodel, variables = _jax_variables(V1)
    batch = synthetic_batch(2, 64, 4, seed=3, num_classes=5, device="cpu")
    np_batch = {k: v.numpy() for k, v in batch.items()}
    step_rng = jax.random.PRNGKey(11)
    ccfg = jax_criterion_config(jcfg)
    targets = {k: jnp.asarray(np_batch[k]) for k in ("labels", "masks", "valid")}
    images = jax_normalize_images(jnp.asarray(np_batch["images"]), jcfg.model)
    params = jax.tree.map(jnp.asarray, variables["params"])

    def loss_fn(p):
        out = jmodel.apply({"params": p, "frozen": variables["frozen"]}, images)
        return jax_set_criterion(out, targets, ccfg, step_rng)

    (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    cfg = get_config("coco_instance_r50", V1)
    trainer = Trainer(cfg, device="cpu")
    trainer.model.load_state_dict(jax_variables_to_state_dict(variables, cfg), strict=True)
    # the standard decoder predicts from dec_layers layers (no raw-query head)
    points = jax_criterion_points(step_rng, cfg.model.decoder.dec_layers, 2, trainer.ccfg)
    metrics = trainer.step(batch, points)
    ref = {"losses": {k: float(v) for k, v in jlosses.items()}, "total": float(jtotal),
           "grad_norm": float(optax.global_norm(jgrads)),
           "grads": jax_tree_to_numpy({"params": to_numpy_tree(jgrads)},
                                      pixel_decoder="transformer_fpn")}
    return ref, metrics, trainer


def test_v1_step_losses_match_jax(v1_step):
    ref, metrics, _ = v1_step
    assert set(metrics) == set(ref["losses"]) | {"total_loss", "grad_norm"}
    assert any(k.startswith("loss_ce_") for k in ref["losses"])  # the aux layer's
    for k, v in ref["losses"].items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(metrics["total_loss"].item(), ref["total"], rtol=1e-4)
    np.testing.assert_allclose(metrics["grad_norm"].item(), ref["grad_norm"], rtol=1e-3)


def test_v1_step_gradients_match_jax(v1_step):
    ref, _, trainer = v1_step
    reached = set()
    for name, p in trainer.model.named_parameters():
        want = ref["grads"][name]
        err = np.linalg.norm(p.grad.numpy() - want)
        assert err <= 1e-3 * np.linalg.norm(want) + 1e-12, (name, err, np.linalg.norm(want))
        if np.linalg.norm(want) > 0:
            reached.add(name.split(".")[1] if name.startswith("sem_seg_head") else "backbone")
    # the encoder, the decoder, the FPN and the heads all have gradients
    assert {"pixel_decoder", "predictor", "backbone"} <= reached
    enc = "sem_seg_head.pixel_decoder.transformer.encoder.layers.1.self_attn.in_proj_weight"
    dec = "sem_seg_head.predictor.transformer.decoder.layers.0.multihead_attn.in_proj_weight"
    assert np.linalg.norm(ref["grads"][enc]) > 0 and np.linalg.norm(ref["grads"][dec]) > 0


def test_fpn_masked_model_trains():
    """`fpn` + `multi_scale_masked` through the unchanged `Trainer`: two
    steps, finite losses, the parameters move."""
    over = {**TINY_V1, "model.pixel_decoder.name": "fpn"}
    trainer = Trainer(get_config("coco_instance_r50", over), device="cpu")
    before = trainer.model.sem_seg_head.pixel_decoder.layer_1.weight.detach().clone()
    for seed in (1, 2):
        metrics = trainer.step(synthetic_batch(2, 64, 3, seed=seed, num_classes=5, device="cpu"))
        assert all(np.isfinite(v.item()) for v in metrics.values())
    assert not torch.equal(before, trainer.model.sem_seg_head.pixel_decoder.layer_1.weight)
