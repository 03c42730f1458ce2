"""Data-parallel training of the box-supervised video model with the
temporal pairwise loss: a SMALL `ytvis2021_video_r50_proj_spatpair_temppair`
step of the port at world 2 (two gloo ranks on the CPU, one clip each)
against the JAX package's `Trainer` step on the global batch over a
2-device mesh, and against the port at world 1. The clips hold different
numbers of valid targets (3 and 4) with other boxes, so that the ranks'
counts of valid temporal pairs differ, and the mask head is drawn wide, so
that the pairs' losses differ: the per-rank-mean recipe misses the JAX
step's temporal loss. At step 5 of 10: pairwise warmup 0.5.
Tolerances: `torch_ddp_cases`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.video import build_video_model as jax_build_video_model
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.utils.convert_weights import jax_variables_to_state_dict
from test_torch_weaksup_video import STEP, STEP_OVER, TEMP, _clip_batch
from torch_ddp_cases import (
    JAX_LOSS_RTOL,
    JAX_NORM_RTOL,
    WORLD_REL,
    check_losses,
    check_update,
    run_ranks,
    train_steps,
)
from torch_port_utils import jax_global_step, randomize, to_numpy_tree

VARIANTS = ("ours", "num_masks_only")


@pytest.fixture(scope="module")
def case():
    jcfg = jax_get_config(TEMP, STEP_OVER)
    model = jax_build_video_model(jcfg)
    variables = to_numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 2, 64, 64, 3), jnp.float32)))
    variables = randomize(variables, np.random.RandomState(5), 0.05,
                          only=lambda p: "sampling_offsets" in p or "attention_weights" in p)
    # wide mask logits: the near-zero logits of the init give every pair
    # -log P(same) = log 2, and any mean of them the same value
    variables = randomize(variables, np.random.RandomState(6), 1.0,
                          only=lambda p: "mask_embed" in p)
    batches = [_clip_batch(np.random.RandomState(s)) for s in (10, 11)]
    jmetrics, jparams, _, _ = jax_global_step(TEMP, STEP_OVER, variables, batches[0], step=STEP)
    state = jax_variables_to_state_dict(variables, get_config(TEMP, STEP_OVER))
    points = [None, None]
    one = train_steps(TEMP, STEP_OVER, state, batches, points, step_count=STEP)["ours"]
    two = run_ranks(train_steps, 2, TEMP, STEP_OVER, state, batches, points, VARIANTS, STEP)
    return {"jax": (jmetrics, jparams), "one": one, "two": two}


def check_against_jax(jax_ref, got) -> None:
    jmetrics, jparams = jax_ref
    check_losses(jmetrics, got["metrics"][0], JAX_LOSS_RTOL, JAX_NORM_RTOL, atol=1e-6)
    for name, p in got["params"][0].items():
        np.testing.assert_allclose(p, jparams[name], rtol=0, atol=got["lr"][0], err_msg=name)


def test_temporal_world2_step_matches_the_jax_global_step(case):
    for k in ("loss_mask_projection", "loss_mask_spatial_pairwise",
              "loss_mask_temporal_pairwise", "temp_pair_valid_prop"):
        assert case["jax"][0][k] > 0, k
    check_against_jax(case["jax"], case["two"][0]["ours"])
    check_against_jax(case["jax"], case["one"])


def test_temporal_world2_steps_match_world1_and_agree_across_ranks(case):
    one, r0, r1 = case["one"], case["two"][0]["ours"], case["two"][1]["ours"]
    for want, have in zip(one["metrics"], r0["metrics"]):
        check_losses(want, have, WORLD_REL, WORLD_REL)
    check_update(one, r0["params"][0])
    assert r0["metrics"] == r1["metrics"]
    for name, p in r0["params"][1].items():
        np.testing.assert_array_equal(p, r1["params"][1][name], err_msg=name)
    assert not r0["no_grad"] and not one["no_grad"]


def test_temporal_per_rank_means_fail(case):
    """The per-rank-mean recipe: the temporal loss is the mean of the
    ranks' means, not the global batch's."""
    got = case["two"][0]["num_masks_only"]
    with pytest.raises(AssertionError):
        check_against_jax(case["jax"], got)
    temp = abs(got["metrics"][0]["loss_mask_temporal_pairwise"]
               / case["jax"][0]["loss_mask_temporal_pairwise"] - 1)
    assert temp > 10 * JAX_LOSS_RTOL, temp
