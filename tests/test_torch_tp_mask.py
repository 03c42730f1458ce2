"""Tensor-parallel training of the mask-supervised image model at mesh
(data 1, model 2): a SMALL `coco_instance_r50` step of the port in two
gloo ranks on the CPU, each the whole global batch of 2 images on its share
of the wide parameters, against the JAX package's `Trainer` step on the
same mesh of virtual CPU devices (its state placed by `state_shardings`),
and against the port at world 1. The replicated parameters stay bitwise
equal across the model group. Three wrong recipes each fail the gradient
check: Megatron's f without its backward sum, the row-parallel bias added
on every rank, and grad_norm counting the replicated parameters T times.
Tolerances: `torch_ddp_cases` (what the model axis adds, a two-term sum
per row-parallel output and per f gradient, is one f32 rounding, as the
data axis's is)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.train.trainer import Trainer as JaxTrainer
from bm2f_tpu.train.trainer import criterion_config as jax_criterion_config
from bm2f_tpu_torch.config import get_config
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
MESH = (1, 2)
TP = {**SMALL, "mesh.model": MESH[1]}
WRONG = ("no_f_backward", "bias_every_rank", "norm_replicated_t_times")


def jax_case(mesh):
    """The SMALL model's JAX variables (deformable projections and the
    class head drawn wide, as tests/test_torch_ddp_mask.py, and the
    row-parallel biases drawn), two global
    batches of 2 images at 64x64, the JAX step on the first over `mesh`,
    the port's state and JAX's own points for the first step."""
    jcfg = jax_get_config(CONFIG, SMALL)
    model = JaxTrainer(jax_get_config(CONFIG, {**SMALL, "mesh.data": 1})).model
    variables = to_numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 64, 64, 3), jnp.float32)))
    variables = randomize(variables, np.random.RandomState(5), 0.05,
                          only=lambda p: "sampling_offsets" in p or "attention_weights" in p)
    variables = randomize(variables, np.random.RandomState(6), 1.0,
                          only=lambda p: "class_embed" in p)
    # the row-parallel layers' biases (zero at the init), so that a bias
    # added on every rank shows
    variables = randomize(variables, np.random.RandomState(7), 0.1,
                          only=lambda p: p.endswith("bias") and any(
                              k in p for k in ("linear2", "output_proj", "out_proj")))
    batches = [{k: v.numpy() for k, v in synthetic_batch(2, 64, 4, seed=s, device="cpu")
                .items()} for s in (3, 4)]
    jmetrics, jparams, step_rng, _ = jax_global_step(CONFIG, SMALL, variables, batches[0],
                                                     mesh=mesh)
    cfg = get_config(CONFIG, SMALL)
    state = jax_variables_to_state_dict(variables, cfg)
    points = [jax_criterion_points(step_rng, cfg.model.decoder.dec_layers + 1, 2,
                                   jax_criterion_config(jcfg)), None]
    return (jmetrics, jparams), state, batches, points


@pytest.fixture(scope="module")
def case():
    jax_ref, state, batches, points = jax_case(MESH)
    one = train_steps(CONFIG, SMALL, state, batches, points)["ours"]
    two = run_ranks(train_steps, 2, CONFIG, TP, state, batches, points, ("ours", *WRONG))
    return {"jax": jax_ref, "one": one, "two": two}


def check_against_jax(jax_ref, got) -> None:
    jmetrics, jparams = jax_ref
    check_losses(jmetrics, got["metrics"][0], JAX_LOSS_RTOL, JAX_NORM_RTOL)
    for name, p in got["params"][0].items():
        np.testing.assert_allclose(p, jparams[name], rtol=0, atol=got["lr"][0], err_msg=name)


def check_gradients(one, got) -> None:
    """The first step's losses and grad_norm within WORLD_REL of the one
    process's, and every whole gradient within WORLD_REL of its norm."""
    check_losses(one["metrics"][0], got["metrics"][0], WORLD_REL, WORLD_REL)
    assert set(got["grads"][0]) == set(one["grads"][0])
    for name, g in one["grads"][0].items():
        err = np.abs(got["grads"][0][name] - g).max()
        assert err <= WORLD_REL * max(np.linalg.norm(g), 1e-12), (name, err)


def test_tp_step_matches_the_jax_step_on_the_same_mesh(case):
    """Rank 0's losses, total, grad_norm and gathered parameters after the
    update against the JAX step over the (1, 2) mesh."""
    check_against_jax(case["jax"], case["two"][0]["ours"])
    check_against_jax(case["jax"], case["one"])


def test_tp_steps_match_world1(case):
    """Both ranks: both steps' losses and grad_norm, the first step's whole
    gradients and update, against one process on the global batch (the
    second step on each side's own draws from the seed)."""
    one = case["one"]
    for rank in (0, 1):
        got = case["two"][rank]["ours"]
        check_gradients(one, got)
        for want, have in zip(one["metrics"], got["metrics"]):
            check_losses(want, have, WORLD_REL, WORLD_REL)
        check_update(one, got["params"][0])


def test_replicated_leaves_are_bitwise_equal_across_the_model_group(case):
    r0, r1 = (case["two"][r]["ours"] for r in (0, 1))
    assert r0["metrics"] == r1["metrics"]
    for step in (0, 1):
        assert r0["replicated"][step].keys() == r1["replicated"][step].keys()
        for name, p in r0["replicated"][step].items():
            np.testing.assert_array_equal(p, r1["replicated"][step][name], err_msg=name)
        for name, p in r0["params"][step].items():
            np.testing.assert_array_equal(p, r1["params"][step][name], err_msg=name)
    assert 0 < len(r0["replicated"][0]) < len(r0["params"][0])
    assert not r0["no_grad"] and not r1["no_grad"]


@pytest.mark.parametrize("variant", WRONG)
def test_wrong_recipes_fail_the_gradient_check(case, variant):
    """f without its backward all-reduce leaves partial gradients upstream
    of every column-parallel layer; a bias added before the row-parallel
    sum counts T times in the forward; grad_norm with the replicated
    parameters summed over the model group counts them T times. Each fails
    the check the right recipe passes."""
    got = case["two"][0][variant]
    with pytest.raises(AssertionError):
        check_gradients(case["one"], got)
    if variant == "norm_replicated_t_times":
        assert got["metrics"][0]["grad_norm"] > case["one"]["metrics"][0]["grad_norm"] * 1.2
