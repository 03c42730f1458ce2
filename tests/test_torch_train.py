"""The port's train step against the JAX package's: the optimizer (AdamW,
optax-style clip, parameter groups, schedules) against `make_optimizer`, and
one whole SMALL step (forward, criterion with JAX's own random points,
backward, update) against a JAX `value_and_grad` of the same loss on shared
weights, carried across by `jax_variables_to_state_dict`."""

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
from bm2f_tpu_torch.train.optim import AdamW, make_lr_schedule, param_groups
from bm2f_tpu_torch.train.trainer import Trainer, synthetic_batch
from bm2f_tpu_torch.utils.convert_weights import jax_tree_to_numpy, jax_variables_to_state_dict
from torch_port_utils import SMALL, jax_criterion_points, randomize, to_numpy_tree


@pytest.fixture(scope="module")
def jax_small():
    """The SMALL JAX model, its variables (deformable projections drawn
    from N(0, 0.05) so that sampling locations move) and its config."""
    cfg = jax_get_config("coco_instance_r50", SMALL)
    model = jax_build_model(cfg)
    sample = jnp.zeros((1, 64, 64, 3), jnp.float32)
    variables = to_numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(0), sample))
    variables = randomize(
        variables, np.random.RandomState(5), 0.05,
        only=lambda p: "sampling_offsets" in p or "attention_weights" in p)
    return cfg, model, variables


def _port_keys(params_tree, pixel_decoder: str = "msdeform") -> dict:
    """A JAX params-shaped tree under the port's state_dict keys."""
    return jax_tree_to_numpy({"params": params_tree}, pixel_decoder=pixel_decoder)


def _port_model(variables):
    cfg = get_config("coco_instance_r50", SMALL)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables, cfg), strict=True)
    return cfg, model


# -- optimizer ---------------------------------------------------------------


def check_param_groups(variables, model, cfg) -> dict:
    """Every parameter's (LR multiplier, decayed) against the JAX path rule
    (bm2f_tpu/train/optim.py:23-42), tensor by tensor. Returns the groups by
    name."""
    def tagged(fn):
        return jax.tree_util.tree_map_with_path(
            lambda p, x: np.full(np.shape(x), fn(jax_optim._path_str(p)), np.float64),
            variables["params"])

    pd = cfg.model.pixel_decoder.name
    lr_ref = _port_keys(tagged(lambda s: 0.1 if jax_optim._is_backbone(s) else 1.0), pd)
    wd_ref = _port_keys(tagged(lambda s: 0.0 if jax_optim._no_decay(s) else 1.0), pd)
    groups = param_groups(model, cfg.train.optimizer)
    assert {g.name for g in groups} == set(lr_ref) == set(dict(model.named_parameters()))
    for g in groups:
        assert np.unique(lr_ref[g.name]).tolist() == [g.lr_mult], g.name
        assert np.unique(wd_ref[g.name]).tolist() == [float(g.decay)], g.name
    return {g.name: g for g in groups}


def test_param_groups_match_jax(jax_small):
    """Every parameter's (LR multiplier, decayed) against the JAX path rule,
    tensor by tensor."""
    _, _, variables = jax_small
    cfg, model = _port_model(variables)
    by_name = check_param_groups(variables, model, cfg)
    n_no_decay = sum(not g.decay for g in by_name.values())
    # GroupNorm inside nn.Sequential (`input_proj.N.1`) has no "norm" in its
    # name; the module rule must still exempt it
    assert not by_name["sem_seg_head.pixel_decoder.input_proj.0.1.weight"].decay
    assert n_no_decay > 20


@pytest.mark.parametrize("preset,steps", [
    ("coco_instance_r50", [0, 1, 9, 10, 11, 327777, 327778, 355091, 355092, 368749]),
    ("ade20k_semantic_r50", [0, 1, 1000, 80000, 159999, 160000, 170000]),
])
@pytest.mark.parametrize("warmup", [(10, 1.0), (1500, 0.001)])
def test_lr_schedules_match_jax(preset, steps, warmup):
    over = {"train.optimizer.warmup_iters": warmup[0],
            "train.optimizer.warmup_factor": warmup[1]}
    ours = make_lr_schedule(get_config(preset, over).train.optimizer)
    ref = jax_optim.make_lr_schedule(jax_get_config(preset, over).train.optimizer)
    assert get_config(preset).train.optimizer.lr_schedule == (
        "poly" if preset.startswith("ade20k") else "multistep")
    # JAX computes in f32, where 1 - step/max_iter loses digits near the
    # end of a poly schedule: hence atol 1e-6 of the base LR beside rtol 1e-6
    base_lr = get_config(preset).train.optimizer.base_lr
    for s in steps:
        np.testing.assert_allclose(ours(s), float(ref(s)), rtol=1e-6,
                                   atol=1e-6 * base_lr, err_msg=str(s))


def test_adamw_matches_make_optimizer(jax_small):
    """3 updates on identical gradients; the first is below the clip norm
    (no clipping), the others far above it. Warm-up changes the LR."""
    _, _, variables = jax_small
    over = {"train.optimizer.warmup_factor": 0.1}
    jcfg = jax_get_config("coco_instance_r50", {**SMALL, **over})
    params = jax.tree.map(jnp.asarray, variables["params"])
    rng = np.random.RandomState(1)
    grad_trees = []
    for scale in (1e-6, 1e-2, 3e-2):
        grad_trees.append(jax.tree.map(
            lambda x: jnp.asarray(rng.randn(*np.shape(x)).astype(np.float32) * scale),
            params))
    assert float(optax.global_norm(grad_trees[0])) < 0.01 < float(
        optax.global_norm(grad_trees[1]))

    tx = jax_optim.make_optimizer(jcfg.train.optimizer, params)
    state = tx.init(params)
    update = jax.jit(tx.update)
    for g in grad_trees:
        updates, state = update(g, state, params)
        params = optax.apply_updates(params, updates)

    cfg, model = _port_model(variables)
    opt = AdamW(model, get_config("coco_instance_r50", {**SMALL, **over}).train.optimizer)
    named = dict(model.named_parameters())
    for g in grad_trees:
        for k, v in _port_keys(g).items():
            named[k].grad = torch.from_numpy(np.array(v))
        norm = opt.step()
        # against the norm in f64: XLA's f32 sum over ~8.7M squares is off by
        # ~1e-5 relative, torch's pairwise sums are not
        want = np.sqrt(sum(np.sum(np.square(np.asarray(x, np.float64)))
                           for x in jax.tree.leaves(g)))
        np.testing.assert_allclose(norm.item(), want, rtol=1e-6)
    ref = _port_keys(params)
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)


# -- the whole step ----------------------------------------------------------


@pytest.fixture(scope="module")
def small_step(jax_small):
    """One step of both packages at SMALL on (2, 64, 64, 3): 4 targets per
    image, 2 of image 0 padding."""
    jcfg, jmodel, variables = jax_small
    batch = synthetic_batch(2, 64, 4, seed=3, device="cpu")
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
    tx = jax_optim.make_optimizer(jcfg.train.optimizer, params)
    updates, _ = jax.jit(tx.update)(jgrads, tx.init(params), params)
    jnew = optax.apply_updates(params, updates)

    cfg = get_config("coco_instance_r50", SMALL)
    trainer = Trainer(cfg, device="cpu")
    trainer.model.load_state_dict(jax_variables_to_state_dict(variables, cfg), strict=True)
    points = jax_criterion_points(step_rng, cfg.model.decoder.dec_layers + 1, 2,
                                  trainer.ccfg)
    metrics = trainer.step(batch, points)
    ref = {"losses": {k: float(v) for k, v in jlosses.items()},
           "total": float(jtotal), "grad_norm": float(optax.global_norm(jgrads)),
           "grads": _port_keys(jgrads), "params": _port_keys(jnew)}
    return ref, metrics, trainer


def test_small_step_losses_match_jax(small_step):
    ref, metrics, _ = small_step
    assert set(metrics) == set(ref["losses"]) | {"total_loss", "grad_norm"}
    for k, v in ref["losses"].items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(metrics["total_loss"].item(), ref["total"], rtol=1e-4)
    np.testing.assert_allclose(metrics["grad_norm"].item(), ref["grad_norm"], rtol=1e-3)


def test_small_step_gradients_match_jax(small_step):
    """Every parameter's gradient within a norm-relative 1e-3, including
    the deformable projections whose gradient goes through the
    closed-form backward."""
    ref, _, trainer = small_step
    checked = 0
    for name, p in trainer.model.named_parameters():
        want = ref["grads"][name]
        err = np.linalg.norm(p.grad.numpy() - want)
        assert err <= 1e-3 * np.linalg.norm(want) + 1e-12, (name, err, np.linalg.norm(want))
        checked += ".self_attn.sampling_offsets." in name and np.linalg.norm(want) > 0
    assert checked == 4  # weight and bias of both encoder layers


# AdamW's first update, u = lr mult (g/(|g| + eps) + wd p) on the clipped
# gradient g (clip 0.01 against a norm of ~164 here: |g| from ~1e-10 to
# ~1e-3, eps 1e-8). Its error, element by element, propagated from:
# - the gradient, held above to 1e-3 of its tensor's norm (and the norm it is
#   clipped by to rtol 1e-3): |dg| <= tau = 1e-3 (|g|_tensor + |g|), and
#   du/dg = lr mult eps / (|g| + eps)^2, capped at the 2 lr mult a sign flip
#   can move it;
# - JAX's Adam constants in f32: 1 - b2 (b2 = 0.999) is 1.29e-5 off in f32,
#   3.6e-7 for b1, which moves g/(|g| + eps) by ~6.5e-6 of itself
#   (ADAM_F32_REL; read 6.9e-6 on a CPU wherever |g| >> eps);
# - and the rounding of the new parameter in each framework, an ulp each.
ADAM_EPS, ADAM_F32_REL, GRAD_REL = 1e-8, 1e-5, 1e-3


def _update_bound(g, lr_eff, ulp):
    """The largest |update_port - update_jax| the error model allows, per
    element; g the clipped gradient (f64)."""
    ag = np.abs(g)
    tau = GRAD_REL * (np.linalg.norm(g) + ag)
    return lr_eff * (ADAM_F32_REL * ag / (ag + ADAM_EPS)
                     + np.minimum(ADAM_EPS * tau / (ag + ADAM_EPS) ** 2, 2.0)) + 2 * ulp


def _update_excess(small_step, jax_small, perturb=None):
    """max |d_port - d_jax| / bound of every parameter tensor, where d is the
    update (new minus old); `perturb(d_port, old, group)` stands in for a
    wrong optimizer."""
    ref, _, trainer = small_step
    old = _port_keys(jax_small[2]["params"])
    opt = trainer.optimizer
    lr = opt.schedule(0)
    norm = ref["grad_norm"]
    clip = opt.cfg.clip_gradients / norm if norm >= opt.cfg.clip_gradients else 1.0
    groups = {g.name: g for g in opt.groups}
    excess = {}
    for name, p in trainer.model.named_parameters():
        new, want = p.detach().numpy(), ref["params"][name]
        ulp = np.spacing(np.maximum(np.abs(old[name]), np.abs(want))).astype(np.float64)
        d_port = new.astype(np.float64) - old[name]
        d_jax = want.astype(np.float64) - old[name]
        if perturb is not None:
            d_port = perturb(d_port, old[name].astype(np.float64), groups[name])
        bound = _update_bound(ref["grads"][name].astype(np.float64) * clip,
                              lr * groups[name].lr_mult, ulp)
        excess[name] = float((np.abs(d_port - d_jax) / bound).max())
    return excess


def test_small_step_parameters_match_jax(small_step, jax_small):
    """Every element of the update (new minus old) within the error model's
    bound of JAX's (`_update_bound`), and within atol = lr."""
    ref, _, trainer = small_step
    lr = trainer.optimizer.schedule(0)
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref["params"][name], rtol=0,
                                   atol=lr, err_msg=name)
    excess = _update_excess(small_step, jax_small)
    worst = max(excess, key=excess.get)
    assert excess[worst] <= 1.0, (worst, excess[worst])


def test_small_step_update_bound_catches_a_wrong_lr_or_decay(small_step, jax_small):
    """The bound refuses an update whose learning rate (or LR multiplier) is
    1 % off, in every tensor, and one whose weight decay is half what it
    should be (or applied where it should not be), in every tensor whose
    parameter is not zero."""
    wd = small_step[2].optimizer.cfg.weight_decay
    wrong_lr = _update_excess(small_step, jax_small, lambda d, old, grp: d * 1.01)
    assert min(wrong_lr.values()) > 1.0, min(wrong_lr, key=wrong_lr.get)
    ref, _, trainer = small_step
    lr = trainer.optimizer.schedule(0)
    wrong_wd = _update_excess(
        small_step, jax_small,
        lambda d, old, grp: d + lr * grp.lr_mult * (0.5 * wd if grp.decay else -wd) * old)
    nonzero = {k for k, v in _port_keys(jax_small[2]["params"]).items() if np.any(v != 0)}
    assert nonzero and all(wrong_wd[k] > 1.0 for k in nonzero), [
        k for k in nonzero if wrong_wd[k] <= 1.0][:5]
