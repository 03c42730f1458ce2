"""Data-parallel training of the mask-supervised image model: a SMALL
`coco_instance_r50` step of the port at world 2 (two gloo ranks on the CPU,
one image each) against the JAX package's `Trainer` step on the global
batch over a 2-device mesh of virtual CPU devices, whose host LAP runs
through `make_sharded_assign_fn`; and against the port at world 1 on the
same global batch. The two images hold different numbers of valid targets
(2 and 4) and the class head is drawn wide, so that each rank's class CE
weight sum and mean differ from the other's: a recipe that averages
per-rank means instead of dividing by the global batch's sums gives
another loss, which the negative check shows. Tolerances:
`torch_ddp_cases`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.matching.hungarian import make_sharded_assign_fn
from bm2f_tpu.parallel.mesh import create_mesh
from bm2f_tpu.train.trainer import Trainer as JaxTrainer
from bm2f_tpu.train.trainer import criterion_config as jax_criterion_config
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.matching.hungarian import make_assign_fn
from bm2f_tpu_torch.train.trainer import synthetic_batch
from bm2f_tpu_torch.utils.convert_weights import jax_variables_to_state_dict
from torch_ddp_cases import (
    JAX_LOSS_RTOL,
    JAX_NORM_RTOL,
    WORLD_REL,
    check_losses,
    check_update,
    run_ranks,
    train_steps,
)
from torch_port_utils import (
    SMALL,
    jax_criterion_points,
    jax_global_step,
    randomize,
    to_numpy_tree,
)

CONFIG = "coco_instance_r50"
VARIANTS = ("ours", "num_masks_only", "mean_grads")


@pytest.fixture(scope="module")
def case():
    """The SMALL model (deformable projections and the class head drawn
    from wider normals), two global batches of 2 images at 64x64 with 4
    targets (image 0: 2 valid), the JAX step on the first, and the port's
    two steps at world 1 (in this process) and at world 2 in every variant
    (in two spawned ranks): the first on JAX's own points, the second on
    the trainers' own draws."""
    jcfg = jax_get_config(CONFIG, SMALL)
    model = JaxTrainer(jax_get_config(CONFIG, {**SMALL, "mesh.data": 1})).model
    variables = to_numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 64, 64, 3), jnp.float32)))
    variables = randomize(variables, np.random.RandomState(5), 0.05,
                          only=lambda p: "sampling_offsets" in p or "attention_weights" in p)
    variables = randomize(variables, np.random.RandomState(6), 1.0,
                          only=lambda p: "class_embed" in p)
    batches = [{k: v.numpy() for k, v in synthetic_batch(2, 64, 4, seed=s, device="cpu")
                .items()} for s in (3, 4)]
    assert batches[0]["valid"].sum(1).tolist() == [2, 4]
    jmetrics, jparams, step_rng, _ = jax_global_step(CONFIG, SMALL, variables, batches[0])
    cfg = get_config(CONFIG, SMALL)
    state = jax_variables_to_state_dict(variables, cfg)
    points = [jax_criterion_points(step_rng, cfg.model.decoder.dec_layers + 1, 2,
                                   jax_criterion_config(jcfg)), None]
    one = train_steps(CONFIG, SMALL, state, batches, points)["ours"]
    two = run_ranks(train_steps, 2, CONFIG, SMALL, state, batches, points, VARIANTS)
    return {"jax": (jmetrics, jparams), "one": one, "two": two}


def check_against_jax(jax_ref, got) -> None:
    jmetrics, jparams = jax_ref
    check_losses(jmetrics, got["metrics"][0], JAX_LOSS_RTOL, JAX_NORM_RTOL)
    lr = got["lr"][0]
    for name, p in got["params"][0].items():
        np.testing.assert_allclose(p, jparams[name], rtol=0, atol=lr, err_msg=name)


def check_against_one_process(one, got) -> None:
    for want, have in zip(one["metrics"], got["metrics"]):
        check_losses(want, have, WORLD_REL, WORLD_REL)
    check_update(one, got["params"][0])


def test_world2_step_matches_the_jax_global_step(case):
    """Rank 0's losses, total, grad_norm and updated parameters against the
    JAX step on the global batch."""
    check_against_jax(case["jax"], case["two"][0]["ours"])


def test_world2_steps_match_world1(case):
    """Both steps' losses and grad_norm, and the first update, against one
    process on the global batch; the second step on each side's own points
    (each rank draws the global batch's and keeps its rows)."""
    check_against_one_process(case["one"], case["two"][0]["ours"])
    check_against_jax(case["jax"], case["one"])


def test_ranks_agree_bitwise_and_every_parameter_has_a_gradient(case):
    r0, r1 = (case["two"][r]["ours"] for r in (0, 1))
    assert r0["metrics"] == r1["metrics"]
    for step in (0, 1):
        for name, p in r0["params"][step].items():
            np.testing.assert_array_equal(p, r1["params"][step][name], err_msg=name)
    assert not r0["no_grad"] and not r1["no_grad"] and not case["one"]["no_grad"]


@pytest.mark.parametrize("variant", ["num_masks_only", "mean_grads"])
def test_upstream_denominators_and_averaged_gradients_fail(case, variant):
    """Upstream Mask2Former's DDP recipe (only `num_masks` over the ranks,
    the rest per-rank means) misses the JAX step's class CE, and DDP's
    default averaging misses its grad_norm by the world size: both fail
    the checks the summing step passes."""
    got = case["two"][0][variant]
    with pytest.raises(AssertionError):
        check_against_jax(case["jax"], got)
    with pytest.raises(AssertionError):
        check_against_one_process(case["one"], got)
    if variant == "mean_grads":
        np.testing.assert_allclose(got["metrics"][0]["grad_norm"] * 2,
                                   case["one"]["metrics"][0]["grad_norm"], rtol=WORLD_REL)
    else:
        ce = abs(got["metrics"][0]["loss_ce"] / case["jax"][0]["loss_ce"] - 1)
        assert ce > 10 * JAX_LOSS_RTOL, ce


def test_sharded_assign_is_the_per_rank_assign():
    """JAX's `make_sharded_assign_fn` over 2 virtual devices on (4, L, Q, G)
    costs against the port's assign of each half, concatenated, as each
    rank assigns its own images: the host LAP and `jv_assign`, the exact
    solvers `train.matcher` picks."""
    rng = np.random.RandomState(0)
    costs = rng.rand(4, 3, 10, 6).astype(np.float32)
    costs[1, :, :, 4:] = 1e6  # padding targets
    want = np.asarray(make_sharded_assign_fn(create_mesh(2, 1))(jnp.asarray(costs)))
    for matcher in ("lap", "jv"):
        fn = make_assign_fn(get_config(CONFIG, {"train.matcher": matcher}))
        got = np.concatenate([fn(torch.from_numpy(costs[r * 2:(r + 1) * 2])).numpy()
                              for r in range(2)])
        np.testing.assert_array_equal(got, want, err_msg=matcher)
