"""Data-parallel training of the box-supervised image model: a SMALL
`coco_instance_r50_wo_lsj_projpair` step of the port at world 2 (two gloo
ranks on the CPU, one image each) against the JAX package's `Trainer` step
on the global batch over a 2-device mesh, and against the port at world 1.
The images hold different numbers of valid targets (3 and 4) and boxes of
other areas, so that the ranks' pairwise weight sums and class CE weight
sums differ: the per-rank-mean recipe (`num_masks` alone over the ranks)
misses the JAX step's pairwise loss. At step 5 of 10: pairwise warmup 0.5,
the pseudo-mask update on. Tolerances: `torch_ddp_cases`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.models import build_model as jax_build_model
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.utils.convert_weights import jax_variables_to_state_dict
from test_torch_weaksup import WEAK, WEAK_OVER, blocky_images, rect_masks
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

STEP = 5
VARIANTS = ("ours", "num_masks_only")


def weak_batch(seed):
    rng = np.random.RandomState(seed)
    valid = np.array([[1, 1, 1, 0], [1, 1, 1, 1]], bool)
    return {"images": blocky_images(rng, 2, 64, 64),
            "labels": np.where(valid, rng.randint(0, 80, (2, 4)), -1).astype(np.int32),
            "masks": rect_masks(rng, 2, 4, 64, 64) * valid[:, :, None, None],
            "valid": valid}


@pytest.fixture(scope="module")
def case():
    jcfg = jax_get_config(WEAK, WEAK_OVER)
    model = jax_build_model(jcfg)
    variables = to_numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 64, 64, 3), jnp.float32)))
    variables = randomize(variables, np.random.RandomState(5), 0.05,
                          only=lambda p: "sampling_offsets" in p or "attention_weights" in p)
    batches = [weak_batch(10), weak_batch(11)]
    jmetrics, jparams, _, _ = jax_global_step(WEAK, WEAK_OVER, variables, batches[0], step=STEP)
    state = jax_variables_to_state_dict(variables, get_config(WEAK, WEAK_OVER))
    points = [None, None]
    one = train_steps(WEAK, WEAK_OVER, state, batches, points, step_count=STEP)["ours"]
    two = run_ranks(train_steps, 2, WEAK, WEAK_OVER, state, batches, points, VARIANTS, STEP)
    return {"jax": (jmetrics, jparams), "one": one, "two": two}


def check_against_jax(jax_ref, got) -> None:
    jmetrics, jparams = jax_ref
    check_losses(jmetrics, got["metrics"][0], JAX_LOSS_RTOL, JAX_NORM_RTOL, atol=1e-6)
    for name, p in got["params"][0].items():
        np.testing.assert_allclose(p, jparams[name], rtol=0, atol=got["lr"][0], err_msg=name)


def test_weak_world2_step_matches_the_jax_global_step(case):
    assert case["jax"][0]["loss_pairwise"] > 0 and case["jax"][0]["loss_mask_projection"] > 0
    check_against_jax(case["jax"], case["two"][0]["ours"])
    check_against_jax(case["jax"], case["one"])


def test_weak_world2_steps_match_world1_and_agree_across_ranks(case):
    one, r0, r1 = case["one"], case["two"][0]["ours"], case["two"][1]["ours"]
    for want, have in zip(one["metrics"], r0["metrics"]):
        check_losses(want, have, WORLD_REL, WORLD_REL)
    check_update(one, r0["params"][0])
    assert r0["metrics"] == r1["metrics"]
    for name, p in r0["params"][1].items():
        np.testing.assert_array_equal(p, r1["params"][1][name], err_msg=name)
    assert not r0["no_grad"] and not one["no_grad"]


def test_weak_per_rank_pairwise_means_fail(case):
    """The per-rank-mean recipe: the pairwise loss is the mean of the
    ranks' means, not the global batch's."""
    got = case["two"][0]["num_masks_only"]
    with pytest.raises(AssertionError):
        check_against_jax(case["jax"], got)
    pair = abs(got["metrics"][0]["loss_pairwise"] / case["jax"][0]["loss_pairwise"] - 1)
    assert pair > 10 * JAX_LOSS_RTOL, pair
