"""Tensor-parallel training of the mask-supervised image model at mesh
(data 2, model 2): a SMALL `coco_instance_r50` step of the port in four
gloo ranks on the CPU (data rank r // 2 holds image r // 2 of the global
batch of 2, model rank r % 2 its share of the wide parameters) against the
JAX package's `Trainer` step on the same (2, 2) mesh of virtual CPU
devices, and against the port at world 1; the replicated parameters
bitwise equal within each model group, and the whole parameters across
all four ranks. Inputs and tolerances: `test_torch_tp_mask`."""

import numpy as np
import pytest

from test_torch_tp_mask import (
    CONFIG,
    SMALL,
    check_against_jax,
    check_gradients,
    jax_case,
)
from torch_ddp_cases import WORLD_REL, check_losses, check_update, run_ranks, train_steps

MESH = (2, 2)


@pytest.fixture(scope="module")
def case():
    jax_ref, state, batches, points = jax_case(MESH)
    one = train_steps(CONFIG, SMALL, state, batches, points)["ours"]
    four = run_ranks(train_steps, 4, CONFIG, {**SMALL, "mesh.model": MESH[1]}, state,
                     batches, points)
    return {"jax": jax_ref, "one": one, "four": [r["ours"] for r in four]}


def test_tp22_step_matches_the_jax_step_on_the_same_mesh(case):
    check_against_jax(case["jax"], case["four"][0])
    check_against_jax(case["jax"], case["four"][3])


def test_tp22_steps_match_world1(case):
    one = case["one"]
    for got in case["four"]:
        check_gradients(one, got)
        for want, have in zip(one["metrics"], got["metrics"]):
            check_losses(want, have, WORLD_REL, WORLD_REL)
        check_update(one, got["params"][0])


def test_tp22_ranks_agree_bitwise(case):
    """Each model group's replicated parameters bitwise equal after both
    steps, and every rank's whole parameters and metrics the same."""
    four = case["four"]
    for a, b in ((0, 1), (2, 3)):
        for step in (0, 1):
            for name, p in four[a]["replicated"][step].items():
                np.testing.assert_array_equal(p, four[b]["replicated"][step][name],
                                              err_msg=name)
    for r in (1, 2, 3):
        assert four[r]["metrics"] == four[0]["metrics"]
        for name, p in four[0]["params"][1].items():
            np.testing.assert_array_equal(p, four[r]["params"][1][name], err_msg=name)
    assert not any(r["no_grad"] for r in four)
