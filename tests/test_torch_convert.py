"""Weights across the packages at full R50 width (no forward): a detectron2
state dict through the JAX converter and back through
`jax_variables_to_state_dict` equals `load_d2_state_dict` of the same dict,
key for key and value for value, and fills the port's R50 Mask2Former
exactly."""

import numpy as np
import pytest
import torch

from bm2f_tpu.utils.convert_weights import convert_checkpoint
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.models.maskformer import MaskFormer
from bm2f_tpu_torch.utils.convert_weights import (
    jax_variables_to_state_dict,
    load_d2_state_dict,
)
from torch_oracle import make_r50_m2f_state_dict


@pytest.fixture(scope="module")
def converted():
    sd = make_r50_m2f_state_dict(np.random.RandomState(0))
    jax_vars = convert_checkpoint(sd)
    cfg = get_config("coco_instance_r50")
    return sd, jax_vars, jax_variables_to_state_dict(jax_vars, cfg), cfg


def test_jax_tree_equals_d2_load(converted):
    sd, _, from_jax, _ = converted
    from_d2 = load_d2_state_dict(sd)
    assert sorted(from_jax) == sorted(from_d2)
    for k in from_d2:
        assert torch.equal(from_jax[k], from_d2[k]), k


def test_state_dict_fills_r50_model_and_param_count_matches_jax(converted):
    _, jax_vars, from_jax, cfg = converted
    model = MaskFormer(cfg.model)
    model.load_state_dict(from_jax, strict=True)
    n_port = sum(p.numel() for p in model.parameters())
    n_jax = sum(np.asarray(x).size for x in _leaves(jax_vars["params"]))
    assert n_port == n_jax
    assert 43e6 < n_port < 45.5e6  # Mask2Former R50 ~44.0M (tests/test_model.py)


def test_leftover_or_missing_leaves_raise(converted):
    _, jax_vars, _, cfg = converted
    extra = {"params": dict(jax_vars["params"], stray={"kernel": np.zeros((2, 2))}),
             "frozen": jax_vars["frozen"]}
    with pytest.raises(KeyError, match="stray"):
        jax_variables_to_state_dict(extra, cfg)
    head = dict(jax_vars["params"]["sem_seg_head"])
    pred = dict(head["predictor"])
    del pred["class_embed"]
    missing = {"params": dict(jax_vars["params"],
                              sem_seg_head=dict(head, predictor=pred)),
               "frozen": jax_vars["frozen"]}
    with pytest.raises(KeyError, match="class_embed"):
        jax_variables_to_state_dict(missing, cfg)


def test_d2_legacy_names_and_buffers(converted):
    sd = dict(converted[0])
    sd["sem_seg_head.predictor.static_query.weight"] = sd.pop(
        "sem_seg_head.predictor.query_feat.weight")
    sd["criterion.empty_weight"] = np.ones(81, np.float32)
    out = load_d2_state_dict(sd)
    assert "sem_seg_head.predictor.query_feat.weight" in out
    assert not any(k.startswith("criterion.") for k in out)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
