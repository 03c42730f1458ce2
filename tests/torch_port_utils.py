"""Helpers shared by the port's parity tests (tests/test_torch_*.py): the
JAX-tree -> port-state_dict mapping for sub-modules."""

from __future__ import annotations

from typing import Dict

import jax
import numpy as np
import torch

from bm2f_tpu_torch.utils.convert_weights import jax_tree_to_numpy


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


def randomize(tree, rng: np.random.RandomState, scale: float = 0.05,
              only=lambda path: True):
    """Replace the leaves `only(path)` selects with seeded N(0, scale)."""
    def f(path, leaf):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if not only(name):
            return leaf
        return np.asarray(rng.randn(*np.shape(leaf)) * scale, np.float32)
    return jax.tree_util.tree_map_with_path(f, tree)
