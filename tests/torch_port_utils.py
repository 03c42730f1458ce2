"""Helpers shared by the port's parity tests (tests/test_torch_*.py): the
SMALL model overrides, the JAX-tree -> port-state_dict mapping for
sub-modules, seeded weight perturbation, and the JAX criterion's own random
points in the port's layout."""

from __future__ import annotations

from typing import Dict

import jax
import numpy as np
import torch

from bm2f_tpu_torch.utils.convert_weights import jax_tree_to_numpy

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


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def submodule_state_dict(variables, jax_prefix: str, port_prefix: str,
                         n_levels: int = 3) -> Dict[str, torch.Tensor]:
    """JAX variables of a sub-module, placed at `jax_prefix` of the full
    model's tree, as the state_dict of the port's module at `port_prefix`."""
    def nest(tree):
        for part in reversed(jax_prefix.split("/")):
            tree = {part: tree}
        return tree

    wrapped = {coll: nest(to_numpy_tree(sub)) for coll, sub in variables.items()}
    flat = jax_tree_to_numpy(wrapped, n_levels)
    return {k[len(port_prefix) + 1:]: torch.tensor(np.asarray(v))
            for k, v in flat.items()}


def jax_criterion_points(rng, n_layers: int, batch: int, ccfg) -> Dict[str, torch.Tensor]:
    """The uniform points the JAX package's `set_criterion` draws from `rng`
    (bm2f_tpu/losses/criterion.py:208, matcher.py:101, criterion.py:106-151),
    in the port's `draw_points` layout: rngs = split(rng, 2L+1); layer i's
    matcher points from rngs[i]; its candidate and random points from
    r1, r2 = split(rngs[L + i])."""
    import jax.numpy as jnp

    n_imp = int(ccfg.importance_sample_ratio * ccfg.num_points)
    n_cand = int(ccfg.num_points * ccfg.oversample_ratio)
    rngs = jax.random.split(rng, 2 * n_layers + 1)
    match, cand, rand = [], [], []
    for i in range(n_layers):
        match.append(jax.random.uniform(rngs[i], (batch, ccfg.num_points, 2), jnp.float32))
        r1, r2 = jax.random.split(rngs[n_layers + i])
        cand.append(jax.random.uniform(r1, (batch, n_cand, 2), jnp.float32))
        rand.append(jax.random.uniform(r2, (batch, ccfg.num_points - n_imp, 2),
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
