"""The port's video criterion against the JAX package's, on the same model
outputs and JAX's own random draws (`jax_criterion_points(..., frames=T)`:
the matcher's points per clip, the losses' per frame): the clip-level
matcher costs, the assignment, `video_set_criterion`'s losses and their
gradients with respect to every layer's logits and masks, and one SMALL
video train step (the port's `Trainer` against JAX's value_and_grad of the
video model and criterion on shared weights).

Sizes: 2 aux layers + the final one, B=2 clips of T=3 frames, 8 queries, 40
classes, 16x16 mask logits, 3 targets a clip at 64x64 (the last one of clip
0 padding), 2000 points.

Error model: the costs and losses are means over up to P*T = 6000 (point,
frame) terms of O(1) values, summed in another order (the port contracts
(point, frame) as one axis): f32 reassociation of ~1e-7 relative a term
grows with sqrt(n) to ~1e-5 relative; rtol 1e-5 with atol 1e-6 for the
values near 0, as tests/test_torch_criterion.py. The step goes through the
network first: its losses within 1e-4 relative and each parameter's
gradient within a norm-relative 1e-3, as the image step's
(tests/test_torch_train.py).

The port's own padding, as in tests/test_torch_criterion.py: at G = 100
with holes in the validity, and with none valid, the losses and gradients
over the occupied slots are the all-slot formulation's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.losses.criterion import SetCriterionConfig as JaxCriterionConfig
from bm2f_tpu.losses.video_criterion import video_matcher_costs as jax_video_costs
from bm2f_tpu.losses.video_criterion import video_set_criterion as jax_video_criterion
from bm2f_tpu.matching.hungarian import assign_fn_default
from bm2f_tpu.models.maskformer import normalize_images as jax_normalize_images
from bm2f_tpu.train.trainer import criterion_config as jax_criterion_config
from bm2f_tpu.video import build_video_model as jax_build_video_model
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.losses.criterion import SetCriterionConfig, draw_points, point_mask_losses
from bm2f_tpu_torch.losses.deep_supervision import StepTargets, deep_supervision
from bm2f_tpu_torch.losses.video_criterion import (
    clip_channels_last,
    frame_major,
    video_matcher_costs,
    video_set_criterion,
)
from bm2f_tpu_torch.matching.hungarian import assign
from bm2f_tpu_torch.train.trainer import Trainer
from bm2f_tpu_torch.utils.convert_weights import jax_tree_to_numpy, jax_variables_to_state_dict
from torch_port_utils import (
    SMALL,
    compare_with_all_slots,
    jax_criterion_points,
    randomize,
    to_numpy_tree,
)

L_AUX, B, Q, K, G, T, h, Hg, P = 2, 2, 8, 40, 3, 3, 16, 64, 2000
RTOL = dict(rtol=1e-5, atol=1e-6)


def _case(seed=0):
    rng = np.random.RandomState(seed)
    outputs = {
        "pred_logits": (rng.randn(B, Q, K + 1) * 2).astype(np.float32),
        "pred_masks": (rng.randn(B, Q, T, h, h) * 3).astype(np.float32),
        "aux_logits": (rng.randn(L_AUX, B, Q, K + 1) * 2).astype(np.float32),
        "aux_masks": (rng.randn(L_AUX, B, Q, T, h, h) * 3).astype(np.float32),
    }
    # blocky 0/1 targets (8x8 cells) that change from frame to frame
    cells = rng.rand(B, G, T, Hg // 8, Hg // 8) > 0.6
    valid = np.ones((B, G), bool)
    valid[0, -1] = False
    targets = {
        "labels": rng.randint(0, K, (B, G)).astype(np.int32),
        "masks": np.kron(cells, np.ones((8, 8))).astype(np.float32) * valid[:, :, None, None,
                                                                              None],
        "valid": valid,
    }
    return outputs, targets


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def test_video_matcher_costs_match_jax():
    outputs, targets = _case(1)
    key = jax.random.PRNGKey(3)
    costs = jax.jit(lambda *a: jax_video_costs(*a, num_points=P, cost_class=2.0,
                                               cost_mask=5.0, cost_dice=5.0))
    ref = np.asarray(costs(
        jnp.asarray(outputs["pred_logits"]), jnp.asarray(outputs["pred_masks"]),
        jnp.asarray(targets["labels"]), jnp.asarray(targets["masks"]),
        jnp.asarray(targets["valid"]), key))
    coords = torch.from_numpy(np.asarray(jax.random.uniform(key, (B, P, 2), jnp.float32)))
    t = _torch(targets)
    ours = video_matcher_costs(
        torch.from_numpy(outputs["pred_logits"]), torch.from_numpy(outputs["pred_masks"]),
        t["labels"], clip_channels_last(t["masks"]), t["valid"], coords).numpy()
    assert ours.shape == ref.shape == (B, Q, G)
    np.testing.assert_allclose(ours, ref, **RTOL)


@pytest.fixture(scope="module")
def criterion_results():
    outputs, targets = _case(2)
    key = jax.random.PRNGKey(7)
    jcfg = JaxCriterionConfig(num_classes=K, num_points=P)

    def loss(o):
        seen = []

        def jassign(c):
            seen.append(c)
            return assign_fn_default(c)

        total, losses = jax_video_criterion(o, {k: jnp.asarray(v) for k, v in targets.items()},
                                            jcfg, key, assign_fn=jassign)
        return total, (losses, seen[0])

    (jtotal, (jlosses, jcosts)), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in outputs.items()})

    ccfg = SetCriterionConfig(num_classes=K, num_points=P)
    points = jax_criterion_points(key, L_AUX + 1, B, ccfg, frames=T)
    seen = {}

    def tassign(c):
        seen["costs"], seen["asg"] = c, assign(c)
        return seen["asg"]

    leaves = {k: v.requires_grad_(True) for k, v in _torch(outputs).items()}
    total, losses = video_set_criterion(leaves, _torch(targets), ccfg, points,
                                        assign_fn=tassign)
    total.backward()
    ref = (float(jtotal), {k: float(v) for k, v in jlosses.items()},
           {k: np.asarray(v) for k, v in jgrads.items()}, np.asarray(jcosts))
    return ref, (total, losses, leaves, seen)


def test_video_criterion_costs_and_assignment_match_jax(criterion_results):
    (_, _, _, jcosts), (_, _, _, seen) = criterion_results
    np.testing.assert_allclose(seen["costs"].numpy(), jcosts, **RTOL)
    np.testing.assert_array_equal(seen["asg"].numpy(), np.asarray(assign_fn_default(jcosts)))


def test_video_criterion_losses_match_jax(criterion_results):
    (jtotal, jlosses, _, _), (total, losses, _, _) = criterion_results
    assert set(losses) == set(jlosses)
    assert len(losses) == 3 * (L_AUX + 1)
    for k, v in jlosses.items():
        np.testing.assert_allclose(losses[k].item(), v, err_msg=k, **RTOL)
    np.testing.assert_allclose(total.item(), jtotal, **RTOL)


@pytest.mark.parametrize("key", ["pred_logits", "pred_masks", "aux_logits", "aux_masks"])
def test_video_criterion_gradients_match_jax(criterion_results, key):
    (_, _, jgrads, _), (_, _, leaves, _) = criterion_results
    got, want = leaves[key].grad.numpy(), jgrads[key]
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_padding_targets_change_no_loss():
    """The padding target's rows weigh nothing: the losses are those of the
    batch without it (its (b, t, g) rows ordered as the validity weights)."""
    outputs, targets = _case(3)
    ccfg = SetCriterionConfig(num_classes=K, num_points=P)
    points = {k: v for k, v in jax_criterion_points(jax.random.PRNGKey(1), L_AUX + 1, B, ccfg,
                                                    frames=T).items()}
    full = _torch(targets)
    garbage = dict(full)
    garbage["masks"] = full["masks"].clone()
    garbage["masks"][0, -1] = 1.0  # a full mask on the padding target
    garbage["labels"] = full["labels"].clone()
    garbage["labels"][0, -1] = 3
    a = video_set_criterion(_torch(outputs), full, ccfg, points)[1]
    b = video_set_criterion(_torch(outputs), garbage, ccfg, points)[1]
    for k in a:
        assert a[k].item() == b[k].item(), k


# -- the occupied slots against the all-slot formulation ------------------------------------

G_PAD, Q_PAD = 100, 100
# (clip 0's valid slots, clip 1's, G')
OCCUPANCY = {"holes": ([0, 5, 17], [5], 18), "none": ([], [], 0)}


def padded_clips(occupancy, seed=4):
    """Outputs of Q_PAD queries and G_PAD target slots of T frames holding
    the valid targets of `occupancy` (the padding slots hold masks too)."""
    g = torch.Generator().manual_seed(seed)
    outputs = {
        "pred_logits": torch.randn(B, Q_PAD, K + 1, generator=g) * 2,
        "pred_masks": torch.randn(B, Q_PAD, T, h, h, generator=g) * 3,
        "aux_logits": torch.randn(L_AUX, B, Q_PAD, K + 1, generator=g) * 2,
        "aux_masks": torch.randn(L_AUX, B, Q_PAD, T, h, h, generator=g) * 3,
    }
    cells = torch.rand(B, G_PAD, T, Hg // 8, Hg // 8, generator=g) > 0.6
    valid = torch.zeros(B, G_PAD, dtype=torch.bool)
    for b, slots in enumerate(occupancy[:2]):
        valid[b, slots] = True
    targets = {"labels": torch.randint(0, K, (B, G_PAD), generator=g),
               "masks": cells.float().repeat_interleave(8, 3).repeat_interleave(8, 4),
               "valid": valid}
    return outputs, targets


def all_slot_video_criterion(outputs, targets, cfg, points, assignment):
    """The video mask criterion over every slot under a given assignment:
    each slot's matched (instance, frame) masks by `torch.gather` over
    their pixels, the padding slots' terms weighted by 0."""
    valid = targets["valid"]
    tgt_frames = frame_major(targets["masks"].float()).contiguous()

    def layer_losses(i, masks, asg, num_masks, sums):
        Bm, Qm, Tm, hm, wm = masks.shape
        G = valid.shape[1]
        src = torch.gather(masks, 1,
                           asg[:, :, None, None, None].expand(Bm, G, Tm, hm, wm)).float()
        w = valid[:, None, :].expand(Bm, Tm, G).reshape(-1).float()
        sums = point_mask_losses(frame_major(src)[None], tgt_frames, w, cfg,
                                 points["cand"][i][None], points["rand"][i][None])
        return {name: s[0] / num_masks for name, s in sums.items()}

    return deep_supervision(outputs, targets["labels"], valid, cfg, lambda c: assignment,
                            lambda i, logits, masks: torch.zeros(B, Q_PAD, G_PAD),
                            lambda a: StepTargets(layer_losses, int(valid.sum())), cfg.loss_weights)


@pytest.mark.parametrize("occupancy", list(OCCUPANCY))
def test_video_criterion_over_occupied_slots_equals_all_slots(occupancy):
    outputs, targets = padded_clips(OCCUPANCY[occupancy])
    cfg = SetCriterionConfig(num_classes=K, num_points=P)
    points = draw_points(cfg, L_AUX + 1, B, torch.Generator().manual_seed(9), frames=T)
    compare_with_all_slots(video_set_criterion, all_slot_video_criterion, outputs, targets,
                           cfg, points, OCCUPANCY[occupancy][2])


# -- one SMALL video step -----------------------------------------------------------------

STEP_OVER = {**SMALL, "model.decoder.dec_layers": 3, "model.loss.train_num_points": 1024,
             "input.max_instances": 3}


@pytest.fixture(scope="module")
def video_step():
    """The SMALL video model on 2 clips of 2 frames at 64x64 with 3 targets
    each (one of clip 0 padding): JAX's value_and_grad of the video model
    and `video_set_criterion`, and the port's `Trainer.step` on the JAX
    criterion's own points."""
    jcfg = jax_get_config("ytvis2019_video_r50", STEP_OVER)
    jmodel = jax_build_video_model(jcfg)
    variables = to_numpy_tree(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 64, 64, 3), jnp.float32)))
    variables = randomize(variables, np.random.RandomState(5), 0.05,
                          only=lambda p: "sampling_offsets" in p or "attention_weights" in p)
    rng = np.random.RandomState(11)
    valid = np.array([[1, 1, 0], [1, 1, 1]], bool)
    cells = rng.rand(2, 3, 2, 8, 8) > 0.5
    batch = {"images": (rng.rand(2, 2, 64, 64, 3) * 255).astype(np.float32),
             "labels": np.where(valid, rng.randint(0, K, (2, 3)), -1).astype(np.int32),
             "masks": np.kron(cells, np.ones((8, 8))).astype(np.float32)
             * valid[:, :, None, None, None],
             "valid": valid}
    key = jax.random.PRNGKey(4)
    ccfg_j = jax_criterion_config(jcfg)

    def loss_fn(p):
        out = jmodel.apply({"params": p, "frozen": variables["frozen"]},
                           jax_normalize_images(jnp.asarray(batch["images"]), jcfg.model))
        return jax_video_criterion(out, {k: jnp.asarray(batch[k])
                                         for k in ("labels", "masks", "valid")}, ccfg_j, key)

    (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, variables["params"]))

    cfg = get_config("ytvis2019_video_r50", STEP_OVER)
    trainer = Trainer(cfg, device="cpu")
    trainer.model.load_state_dict(jax_variables_to_state_dict(variables, cfg), strict=True)
    points = jax_criterion_points(key, cfg.model.decoder.dec_layers + 1, 2, trainer.ccfg,
                                  frames=2)
    metrics = trainer.step(_torch(batch), points)
    ref = {"losses": {k: float(v) for k, v in jlosses.items()}, "total": float(jtotal),
           "grad_norm": float(optax.global_norm(jgrads)),
           "grads": jax_tree_to_numpy({"params": jgrads})}
    return ref, metrics, trainer


def test_small_video_step_losses_match_jax(video_step):
    ref, metrics, _ = video_step
    assert set(metrics) == set(ref["losses"]) | {"total_loss", "grad_norm"}
    for k, v in ref["losses"].items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(metrics["total_loss"].item(), ref["total"], rtol=1e-4)
    np.testing.assert_allclose(metrics["grad_norm"].item(), ref["grad_norm"], rtol=1e-3)


def test_small_video_step_gradients_match_jax(video_step):
    """Every parameter's gradient within a norm-relative 1e-3, the
    deformable projections (K2's path on the card) included."""
    ref, _, trainer = video_step
    checked = 0
    for name, p in trainer.model.named_parameters():
        want = ref["grads"][name]
        err = np.linalg.norm(p.grad.numpy() - want)
        assert err <= 1e-3 * np.linalg.norm(want) + 1e-12, (name, err, np.linalg.norm(want))
        checked += ".self_attn.sampling_offsets." in name and np.linalg.norm(want) > 0
    assert checked == 4  # weight and bias of both encoder layers
