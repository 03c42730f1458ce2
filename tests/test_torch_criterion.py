"""The port's train-step criterion against the JAX package's, on the same
model outputs and JAX's own random draws: `point_sample`, the matcher costs,
the Hungarian assignment on valid targets, and `set_criterion`'s losses and
their gradients with respect to the logits and masks of every layer.

Sizes: 3 aux layers + the final one, B=2, 10 queries, 80 classes, 16x16
mask logits, 4 targets per image at 64x64 (the last one of image 0 is
padding), the default 112*112 points. Tolerance rtol 1e-5: f32 sums of up to
~37k terms in another order.

Then the port's own padding: `set_criterion` takes its mask losses over the
occupied slots only; at G = 100 on prefix, holed, empty and full validity,
its losses and gradients are those of the all-slot formulation (every
slot's matched mask by `torch.gather`, padding weighted by 0) on the same
points and assignment."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bm2f_tpu.losses.criterion import SetCriterionConfig as JaxCriterionConfig
from bm2f_tpu.losses.criterion import set_criterion as jax_set_criterion
from bm2f_tpu.matching.hungarian import hungarian_assign as jax_hungarian_assign
from bm2f_tpu.matching.matcher import hungarian_matcher_costs as jax_matcher_costs
from bm2f_tpu.ops.sampling import point_sample as jax_point_sample
from bm2f_tpu_torch.losses.criterion import (
    SetCriterionConfig,
    draw_points,
    point_mask_losses,
    set_criterion,
)
from bm2f_tpu_torch.losses.deep_supervision import StepTargets, deep_supervision
from bm2f_tpu_torch.matching.hungarian import assign
from bm2f_tpu_torch.matching.matcher import PAD_COST, hungarian_matcher_costs
from bm2f_tpu_torch.ops.sampling import point_sample
from torch_port_utils import compare_with_all_slots, jax_criterion_points

L_AUX, B, Q, K, G, h, Hg = 3, 2, 10, 80, 4, 16, 64
RTOL = dict(rtol=1e-5, atol=1e-6)


def _case(seed=0):
    rng = np.random.RandomState(seed)
    outputs = {
        "pred_logits": (rng.randn(B, Q, K + 1) * 2).astype(np.float32),
        "pred_masks": (rng.randn(B, Q, h, h) * 3).astype(np.float32),
        "aux_logits": (rng.randn(L_AUX, B, Q, K + 1) * 2).astype(np.float32),
        "aux_masks": (rng.randn(L_AUX, B, Q, h, h) * 3).astype(np.float32),
    }
    # blocky 0/1 targets (8x8 cells), so that masks are neither empty nor noise
    cells = rng.rand(B, G, Hg // 8, Hg // 8) > 0.6
    valid = np.ones((B, G), bool)
    valid[0, -1] = False
    targets = {
        "labels": rng.randint(0, K, (B, G)).astype(np.int32),
        "masks": np.kron(cells, np.ones((8, 8))).astype(np.float32),
        "valid": valid,
    }
    return outputs, targets


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def test_point_sample_matches_jax():
    rng = np.random.RandomState(1)
    img = rng.randn(2, 9, 13, 5).astype(np.float32)
    coords = (rng.rand(2, 300, 2) * 1.2 - 0.1).astype(np.float32)  # some outside
    ours = point_sample(torch.from_numpy(img), torch.from_numpy(coords)).numpy()
    ref = np.asarray(jax_point_sample(jnp.asarray(img), jnp.asarray(coords)))
    np.testing.assert_allclose(ours, ref, **RTOL)


@pytest.fixture(scope="module")
def costs():
    outputs, targets = _case()
    coords = np.array(jax.random.uniform(jax.random.PRNGKey(3), (B, 12544, 2)))
    ref = np.asarray(jax_matcher_costs(
        jnp.asarray(outputs["pred_logits"]), jnp.asarray(outputs["pred_masks"]),
        jnp.asarray(targets["labels"]), jnp.asarray(targets["masks"]),
        jnp.asarray(targets["valid"]), jax.random.PRNGKey(3)))
    t = _torch(targets)
    ours = hungarian_matcher_costs(
        torch.from_numpy(outputs["pred_logits"]), torch.from_numpy(outputs["pred_masks"]),
        t["labels"], t["masks"].permute(0, 2, 3, 1).contiguous(), t["valid"],
        torch.from_numpy(coords)).numpy()
    return ours, ref, targets["valid"]


def test_matcher_costs_match_jax(costs):
    ours, ref, valid = costs
    assert ours.shape == ref.shape == (B, Q, G)
    np.testing.assert_array_equal(ours[:, :, ~valid[0]][0], PAD_COST)
    np.testing.assert_allclose(ours, ref, **RTOL)


def test_assignment_matches_jax_on_valid_targets(costs):
    ours_c, ref_c, valid = costs
    stacked = torch.from_numpy(np.stack([ours_c, ours_c[::-1]], 1))  # (B, 2, Q, G)
    ours = assign(stacked).numpy()
    ref = np.asarray(jax_hungarian_assign(jnp.asarray(ref_c)))
    assert ours.shape == (B, 2, G)
    np.testing.assert_array_equal(ours[:, 0][valid], ref[valid])
    for b in range(B):  # every target of every problem gets its own query
        for layer in range(2):
            assert len(set(ours[b, layer])) == G


@pytest.fixture(scope="module")
def criterion_results():
    outputs, targets = _case(2)
    rng = jax.random.PRNGKey(7)
    jcfg = JaxCriterionConfig(num_classes=K)

    def loss(o):
        return jax_set_criterion(o, {k: jnp.asarray(v) for k, v in targets.items()},
                                 jcfg, rng)

    (jtotal, jlosses), jgrads = jax.value_and_grad(loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outputs.items()})

    ccfg = SetCriterionConfig(num_classes=K)
    points = jax_criterion_points(rng, L_AUX + 1, B, ccfg)
    leaves = {k: v.requires_grad_(True) for k, v in _torch(outputs).items()}
    total, losses = set_criterion(leaves, _torch(targets), ccfg, points)
    total.backward()
    return (jtotal, jlosses, jgrads), (total, losses, leaves)


def test_criterion_losses_match_jax(criterion_results):
    (jtotal, jlosses, _), (total, losses, _) = criterion_results
    assert set(losses) == set(jlosses)
    assert {"loss_ce", "loss_mask", "loss_dice", "loss_ce_0", "loss_dice_2"} <= set(losses)
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jlosses[k]), err_msg=k, **RTOL)
    np.testing.assert_allclose(total.item(), float(jtotal), **RTOL)


@pytest.mark.parametrize("key", ["pred_logits", "pred_masks", "aux_logits", "aux_masks"])
def test_criterion_gradients_match_jax(criterion_results, key):
    (_, _, jgrads), (_, _, leaves) = criterion_results
    ref = np.asarray(jgrads[key])
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(leaves[key].grad.numpy(), ref,
                               rtol=1e-5, atol=1e-5 * np.abs(ref).max())


# -- the occupied slots against the all-slot formulation ------------------------------------

G_PAD, Q_PAD = 100, 100
# (image 0's valid slots, image 1's, G')
OCCUPANCY = {
    "prefix": ([0, 1, 2], [0], 3),
    "holes": ([0, 5, 17], [5], 18),
    "none": ([], [], 0),
    "all": (list(range(G_PAD)), list(range(G_PAD)), G_PAD),
}


def padded_case(occupancy, seed=4):
    """Outputs of Q_PAD queries and G_PAD target slots holding the valid
    targets of `occupancy` (the padding slots hold masks and labels too)."""
    g = torch.Generator().manual_seed(seed)
    outputs = {
        "pred_logits": torch.randn(B, Q_PAD, K + 1, generator=g) * 2,
        "pred_masks": torch.randn(B, Q_PAD, h, h, generator=g) * 3,
        "aux_logits": torch.randn(L_AUX, B, Q_PAD, K + 1, generator=g) * 2,
        "aux_masks": torch.randn(L_AUX, B, Q_PAD, h, h, generator=g) * 3,
    }
    cells = torch.rand(B, G_PAD, Hg // 8, Hg // 8, generator=g) > 0.6
    valid = torch.zeros(B, G_PAD, dtype=torch.bool)
    for b, slots in enumerate(occupancy[:2]):
        valid[b, slots] = True
    targets = {"labels": torch.randint(0, K, (B, G_PAD), generator=g),
               "masks": cells.float().repeat_interleave(8, 2).repeat_interleave(8, 3),
               "valid": valid}
    return outputs, targets


def all_slot_criterion(outputs, targets, cfg, points, assignment):
    """The mask criterion over every slot under a given (B, L+1, G)
    assignment: each slot's matched mask by `torch.gather` over its pixels,
    the padding slots' terms weighted by 0."""
    valid = targets["valid"]
    tgt_nhwc = targets["masks"].float().permute(0, 2, 3, 1).contiguous()

    def layer_losses(i, masks, asg, num_masks, sums):
        Bm, Qm, hm, wm = masks.shape
        G = valid.shape[1]
        src = torch.gather(masks, 1, asg[:, :, None, None].expand(Bm, G, hm, wm)).float()
        sums = point_mask_losses(src.permute(0, 2, 3, 1)[None], tgt_nhwc,
                                 valid.reshape(-1).float(), cfg, points["cand"][i][None],
                                 points["rand"][i][None])
        return {name: s[0] / num_masks for name, s in sums.items()}

    return deep_supervision(outputs, targets["labels"], valid, cfg, lambda c: assignment,
                            lambda i, logits, masks: torch.zeros(B, Q_PAD, G_PAD),
                            lambda a: StepTargets(layer_losses, int(valid.sum())), cfg.loss_weights)


@pytest.mark.parametrize("occupancy", list(OCCUPANCY))
def test_criterion_over_occupied_slots_equals_all_slots(occupancy):
    outputs, targets = padded_case(OCCUPANCY[occupancy])
    cfg = SetCriterionConfig(num_classes=K, num_points=2000)
    points = draw_points(cfg, L_AUX + 1, B, torch.Generator().manual_seed(9))
    compare_with_all_slots(set_criterion, all_slot_criterion, outputs, targets, cfg, points,
                           OCCUPANCY[occupancy][2])
