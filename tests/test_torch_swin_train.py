"""One SMALL Swin train step of the port against the JAX package's, as
tests/test_torch_train.py holds the R50 step: the losses, every gradient
(the relative-position bias tables' included) and the updated parameters,
on weights carried across by `jax_variables_to_state_dict` and the JAX
criterion's own random points; the parameter groups against the JAX path
rule (no decay on `relative_position_bias_table` and `absolute_pos_embed`);
and two trainers from one seed ending two steps with the same bits.

Model: `coco_instance_swin_t` with `SMALL_SWIN` (embed 32, heads (1, 2, 4, 8),
depths (2, 2, 3, 2), window 7, SMALL's head), on (2, 64, 64, 3), 4 targets
an image. Tolerances as the R50 step's: losses rtol 1e-4, the gradient norm
1e-3, each gradient 1e-3 of its tensor's norm (a chain of f32 products and
sums in another order, through the same formulas), each update within
`test_torch_train._update_bound`'s error model of JAX's."""

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
from bm2f_tpu.train import optim as jax_optim
from bm2f_tpu.train.trainer import criterion_config as jax_criterion_config
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.models import build_model
from bm2f_tpu_torch.train.trainer import Trainer, synthetic_batch
from bm2f_tpu_torch.utils.convert_weights import jax_variables_to_state_dict
from test_torch_train import _port_keys, _update_bound, check_param_groups
from torch_port_utils import SMALL_SWIN, jax_criterion_points, randomize, to_numpy_tree

PRESET = "coco_instance_swin_t"
APE = {"model.backbone.swin.ape": True, "model.backbone.swin.pretrain_img_size": 64}


def _jax_small(over):
    cfg = jax_get_config(PRESET, {**SMALL_SWIN, **over})
    model = jax_build_model(cfg)
    sample = jnp.zeros((1, 64, 64, 3), jnp.float32)
    variables = to_numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(0), sample))
    variables = randomize(
        variables, np.random.RandomState(5), 0.05,
        only=lambda p: "sampling_offsets" in p or "attention_weights" in p)
    return cfg, model, variables


@pytest.mark.parametrize("over", [{}, APE], ids=["swin", "swin-ape"])
def test_param_groups_match_jax_swin(over):
    """`test_torch_train.check_param_groups` on a SMALL Swin, with and
    without `absolute_pos_embed`."""
    _, _, variables = _jax_small(over)
    cfg = get_config(PRESET, {**SMALL_SWIN, **over})
    model = build_model(cfg, device="cpu")
    by_name = check_param_groups(variables, model, cfg)
    assert not by_name["backbone.layers.2.blocks.2.attn.relative_position_bias_table"].decay
    assert by_name["backbone.layers.2.blocks.2.attn.qkv.weight"].decay
    assert ("backbone.absolute_pos_embed" in by_name) == bool(over)
    if over:
        assert not by_name["backbone.absolute_pos_embed"].decay


@pytest.fixture(scope="module")
def small_step():
    """One step of both packages on (2, 64, 64, 3): 4 targets per image, 2
    of image 0 padding."""
    jcfg, jmodel, variables = _jax_small({})
    batch = synthetic_batch(2, 64, 4, seed=3, device="cpu")
    np_batch = {k: v.numpy() for k, v in batch.items()}
    step_rng = jax.random.PRNGKey(11)
    ccfg = jax_criterion_config(jcfg)
    targets = {k: jnp.asarray(np_batch[k]) for k in ("labels", "masks", "valid")}
    images = jax_normalize_images(jnp.asarray(np_batch["images"]), jcfg.model)
    params = jax.tree.map(jnp.asarray, variables["params"])

    def loss_fn(p):
        out = jmodel.apply({"params": p}, images)
        return jax_set_criterion(out, targets, ccfg, step_rng)

    (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = jax_optim.make_optimizer(jcfg.train.optimizer, params)
    updates, _ = jax.jit(tx.update)(jgrads, tx.init(params), params)
    jnew = optax.apply_updates(params, updates)

    cfg = get_config(PRESET, SMALL_SWIN)
    trainer = Trainer(cfg, device="cpu")
    trainer.model.load_state_dict(jax_variables_to_state_dict(variables, cfg), strict=True)
    points = jax_criterion_points(step_rng, cfg.model.decoder.dec_layers + 1, 2,
                                  trainer.ccfg)
    metrics = trainer.step(batch, points)
    ref = {"losses": {k: float(v) for k, v in jlosses.items()},
           "total": float(jtotal), "grad_norm": float(optax.global_norm(jgrads)),
           "grads": _port_keys(jgrads), "params": _port_keys(jnew),
           "old": _port_keys(variables["params"])}
    return ref, metrics, trainer


def test_small_swin_step_losses_match_jax(small_step):
    ref, metrics, _ = small_step
    assert set(metrics) == set(ref["losses"]) | {"total_loss", "grad_norm"}
    for k, v in ref["losses"].items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(metrics["total_loss"].item(), ref["total"], rtol=1e-4)
    np.testing.assert_allclose(metrics["grad_norm"].item(), ref["grad_norm"], rtol=1e-3)


def test_small_swin_step_gradients_match_jax(small_step):
    """Every parameter's gradient within a norm-relative 1e-3, the bias
    tables' (the backward of their gather) and every stage's included."""
    ref, _, trainer = small_step
    tables = 0
    for name, p in trainer.model.named_parameters():
        want = ref["grads"][name]
        err = np.linalg.norm(p.grad.numpy() - want)
        assert err <= 1e-3 * np.linalg.norm(want) + 1e-12, (name, err, np.linalg.norm(want))
        tables += name.endswith("relative_position_bias_table") and np.linalg.norm(want) > 0
    assert tables == 9  # every block's table gets a gradient


def test_small_swin_step_parameters_match_jax(small_step):
    """Every element of the update within the error model's bound of JAX's
    (tests/test_torch_train.py `_update_bound`), and within atol = lr."""
    ref, _, trainer = small_step
    opt = trainer.optimizer
    lr = opt.schedule(0)
    norm = ref["grad_norm"]
    clip = opt.cfg.clip_gradients / norm if norm >= opt.cfg.clip_gradients else 1.0
    groups = {g.name: g for g in opt.groups}
    worst = (0.0, "")
    for name, p in trainer.model.named_parameters():
        new, want, old = p.detach().numpy(), ref["params"][name], ref["old"][name]
        np.testing.assert_allclose(new, want, rtol=0, atol=lr, err_msg=name)
        ulp = np.spacing(np.maximum(np.abs(old), np.abs(want))).astype(np.float64)
        bound = _update_bound(ref["grads"][name].astype(np.float64) * clip,
                              lr * groups[name].lr_mult, ulp)
        d_port = new.astype(np.float64) - old
        d_jax = want.astype(np.float64) - old
        excess = float((np.abs(d_port - d_jax) / bound).max())
        worst = max(worst, (excess, name))
    assert worst[0] <= 1.0, worst


def test_two_swin_trainers_repeat_bitwise():
    """Two trainers from one seed, two steps each (the trainer's own random
    points), end with the same bits in every parameter, moment and the
    generator: the step, the bias tables' backward included, is
    deterministic."""
    cfg = get_config(PRESET, SMALL_SWIN)
    batches = [synthetic_batch(2, 64, 4, seed=s, device="cpu") for s in (1, 2)]
    states = []
    for _ in range(2):
        trainer = Trainer(cfg, device="cpu", seed=4)
        for batch in batches:
            trainer.step(batch)
        states.append(trainer.state_dict())
    a, b = states
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for m in ("mu", "nu"):
        for k in a["optimizer"][m]:
            assert torch.equal(a["optimizer"][m][k], b["optimizer"][m][k]), (m, k)
    assert torch.equal(a["generator"], b["generator"])
