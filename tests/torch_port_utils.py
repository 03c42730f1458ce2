"""Helpers shared by the port's parity tests (tests/test_torch_*.py): the
SMALL model overrides, the JAX-tree -> port-state_dict mapping for
sub-modules, seeded weight perturbation, the JAX criterion's own random
points in the port's layout, the JAX package's data-parallel step, and a
mask criterion over its occupied slots against its all-slot formulation."""

from __future__ import annotations

from typing import Dict

import jax
import numpy as np
import torch

from bm2f_tpu_torch.losses.criterion import occupied_slots
from bm2f_tpu_torch.matching.hungarian import assign
from bm2f_tpu_torch.utils.convert_weights import jax_tree_to_numpy

# One intra-op thread per test process. The suite runs in several pytest
# workers side by side (xdist), each collecting every test module, so this
# holds in every worker. With torch's default of a thread per core, the
# workers' OpenMP teams oversubscribe the cores, and the barriers of the
# many small ops in the port's plain paths then wait on descheduled
# threads: on an 8-core host a K2 mirror case that takes 2 s alone took
# over 360 s beside three copies of itself. No result depends on the thread
# count beyond the order of a reduction, which every tolerance here covers.
torch.set_num_threads(1)

# the SMALL model of the whole-model tests (`coco_instance_r50` overrides):
# depth-14 ResNet, conv/hidden/mask dim 64, FFN 128, 2 encoder layers, 6
# decoder layers (two stacked rounds in the JAX tree), 10 queries
SMALL = {
    "model.backbone.resnet.depth": 14,
    "model.pixel_decoder.conv_dim": 64,
    "model.pixel_decoder.mask_dim": 64,
    "model.pixel_decoder.transformer_enc_layers": 2,
    "model.pixel_decoder.transformer_dim_feedforward": 128,
    "model.pixel_decoder.deform_impl": "im2col",
    "model.decoder.hidden_dim": 64,
    "model.decoder.mask_dim": 64,
    "model.decoder.dim_feedforward": 128,
    "model.decoder.dec_layers": 6,
    "model.decoder.num_queries": 10,
}

# the SMALL Swin model (a `*_swin_t` preset with these overrides): SMALL's
# head on a Swin of embed 32, heads (1, 2, 4, 8), depths (2, 2, 3, 2) (stage
# 2 odd: the JAX package unrolls it, the even stages scan block pairs),
# window 7
SMALL_SWIN = {
    **{k: v for k, v in SMALL.items() if ".resnet." not in k},
    "model.backbone.swin.embed_dim": 32,
    "model.backbone.swin.depths": (2, 2, 3, 2),
    "model.backbone.swin.num_heads": (1, 2, 4, 8),
    "model.backbone.swin.window_size": 7,
}


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def submodule_state_dict(variables, jax_prefix: str, port_prefix: str,
                         n_levels: int = 3,
                         pixel_decoder: str = "msdeform") -> Dict[str, torch.Tensor]:
    """JAX variables of a sub-module, placed at `jax_prefix` of the full
    model's tree, as the state_dict of the port's module at `port_prefix`
    (`pixel_decoder` the model's `model.pixel_decoder.name`)."""
    def nest(tree):
        for part in reversed(jax_prefix.split("/")):
            tree = {part: tree}
        return tree

    wrapped = {coll: nest(to_numpy_tree(sub)) for coll, sub in variables.items()}
    flat = jax_tree_to_numpy(wrapped, n_levels, pixel_decoder)
    return {k[len(port_prefix) + 1:]: torch.tensor(np.asarray(v))
            for k, v in flat.items()}


def jax_criterion_points(rng, n_layers: int, batch: int, ccfg,
                         frames: int = 1) -> Dict[str, torch.Tensor]:
    """The uniform points the JAX package's `set_criterion` draws from `rng`
    (bm2f_tpu/losses/criterion.py:208, matcher.py:101, criterion.py:106-151),
    in the port's `draw_points` layout: rngs = split(rng, 2L+1); layer i's
    matcher points from rngs[i]; its candidate and random points from
    r1, r2 = split(rngs[L + i]). With `frames` = T, those of
    `video_set_criterion` (bm2f_tpu/losses/video_criterion.py:41, :98-129):
    the matcher's per clip, the losses' per frame."""
    import jax.numpy as jnp

    n_imp = int(ccfg.importance_sample_ratio * ccfg.num_points)
    n_cand = int(ccfg.num_points * ccfg.oversample_ratio)
    rngs = jax.random.split(rng, 2 * n_layers + 1)
    match, cand, rand = [], [], []
    for i in range(n_layers):
        match.append(jax.random.uniform(rngs[i], (batch, ccfg.num_points, 2), jnp.float32))
        r1, r2 = jax.random.split(rngs[n_layers + i])
        cand.append(jax.random.uniform(r1, (batch * frames, n_cand, 2), jnp.float32))
        rand.append(jax.random.uniform(r2, (batch * frames, ccfg.num_points - n_imp, 2),
                                       jnp.float32))
    return {k: torch.from_numpy(np.stack([np.asarray(x) for x in v]))
            for k, v in (("match", match), ("cand", cand), ("rand", rand))}


def randomize(tree, rng: np.random.RandomState, scale: float = 0.05,
              only=lambda path: True):
    """Replace the leaves `only(path)` selects with seeded N(0, scale)."""
    def f(path, leaf):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if not only(name):
            return leaf
        return np.asarray(rng.randn(*np.shape(leaf)) * scale, np.float32)
    return jax.tree_util.tree_map_with_path(f, tree)


def jax_global_step(config, overrides, variables, batch, step=0, key=11, mesh=(2, 1)):
    """One step of the JAX `Trainer` over a (data, model) `mesh` of virtual
    CPU devices (conftest's; (2, 1) by default) on the global `batch`, from
    `variables` at `step` (the AdamW counts too): the data-parallel step of
    the JAX package, with its tensor-parallel state shardings where the
    model axis is > 1, whose host LAP runs through `make_sharded_assign_fn`.
    Returns (metrics, new params under the port's keys, step_rng, the JAX
    config)."""
    import jax.numpy as jnp

    from bm2f_tpu.config import get_config
    from bm2f_tpu.train.optim import make_optimizer
    from bm2f_tpu.train.trainer import Trainer, TrainState

    jcfg = get_config(config, {**overrides, "mesh.data": mesh[0], "mesh.model": mesh[1]})
    trainer = Trainer(jcfg)
    assert trainer.mesh.devices.shape == tuple(mesh)
    params = jax.tree.map(jnp.asarray, variables["params"])
    trainer.tx = make_optimizer(jcfg.train.optimizer, params)
    opt_state = jax.tree.map(
        lambda x: jnp.full_like(x, step) if x.dtype == jnp.int32 and x.ndim == 0 else x,
        trainer.tx.init(params))
    rng = jax.random.PRNGKey(key)
    step_rng = jax.random.split(rng)[1]  # the step donates its state
    state = TrainState(step=jnp.asarray(step, jnp.int32), params=params,
                       frozen=variables["frozen"], opt_state=opt_state, rng=rng)
    step_fn = trainer.compile_step(state)
    with trainer.mesh:
        new, metrics = step_fn(trainer.shard_state(state), batch)
    pixel_decoder = jcfg.model.pixel_decoder.name
    new_params = jax_tree_to_numpy({"params": jax.device_get(new.params)},
                                   pixel_decoder=pixel_decoder)
    return {k: float(v) for k, v in metrics.items()}, new_params, step_rng, jcfg


def compare_with_all_slots(criterion, reference, outputs, targets, cfg, points, expect):
    """`criterion` (under the exact assignment) against `reference`
    (under the same assignment): every term and the gradients of every
    output, rtol 1e-5 and atol 1e-6; with no valid target, the mask terms
    and their gradients exactly 0 and the class CE bitwise the reference's."""
    n_valid, occupied = occupied_slots(targets["valid"])
    assert (n_valid, occupied) == (int(targets["valid"].sum()), expect)
    seen = {}

    def tassign(c):
        seen["asg"] = assign(c)
        return seen["asg"]

    runs = []
    for run in (lambda o: criterion(o, targets, cfg, points, assign_fn=tassign),
                lambda o: reference(o, targets, cfg, points, seen["asg"])):
        leaves = {k: v.clone().requires_grad_(True) for k, v in outputs.items()}
        total, losses = run(leaves)
        total.backward()
        runs.append((total, losses, {k: v.grad for k, v in leaves.items()}))
    (total, losses, grads), (rtotal, rlosses, rgrads) = runs
    assert set(losses) == set(rlosses)
    for k, v in rlosses.items():
        np.testing.assert_allclose(losses[k].item(), v.item(), err_msg=k, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(total.item(), rtotal.item(), rtol=1e-5, atol=1e-6)
    for k, v in rgrads.items():
        np.testing.assert_allclose(grads[k].numpy(), v.numpy(), err_msg=k, rtol=1e-5, atol=1e-6)
    if occupied == 0:
        for k, v in losses.items():
            if k.startswith("loss_ce"):
                assert v.item() == rlosses[k].item(), k
            else:
                assert v.item() == 0.0, k
        assert not grads["pred_masks"].any() and not grads["aux_masks"].any()
    else:
        assert grads["pred_masks"].abs().max() > 0 and grads["aux_masks"].abs().max() > 0
