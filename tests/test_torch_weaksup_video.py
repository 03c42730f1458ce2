"""The port's box-supervised video losses against the JAX package's, on seeded
numpy inputs: `compute_temporal_pairs` (random features, zero features where
every in-box score ties, integer features with exact ties, rows outside
every box, with and without the color filter), the temporal pairwise loss
and its gradient, the weak video matcher costs and criterion for the three
video sup types, `build_video_weaksup_targets` with DINO features, and one
SMALL temporal-pairwise train step against JAX's value_and_grad on shared
weights.

Error model, from what each function computes in f32:
- the temporal pairs are indices: the nearest patch and the best sources
  are picked from distances computed with the same expansion. With random
  features the gaps between candidates are orders of magnitude above f32
  rounding, and zero and small-integer features give exact (tied) values
  in both: every pair and validity flag bitwise equal. (Where two
  candidates' distances differ by less than the rounding of the products,
  as a patch's exact copies do with continuous features, each library
  orders them its own way; the tests' moving features are integers.)
- the box targets: bitwise; the color similarity, as in
  tests/test_torch_weaksup.py: atol 5e-5 (JAX's `cbrt` against `pow`);
- -log P(same) sums of O(1) terms in another order: rtol 1e-5, atol 1e-6
  (1e-7 on gradients, whose terms are 1/n);
- the SMALL step goes through the network first: its losses within 1e-4
  relative and each gradient within a norm-relative 1e-3, as
  tests/test_torch_weaksup.py's weak image step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bm2f_tpu.config import get_config as jax_get_config
from bm2f_tpu.losses import target_prep as jax_tp
from bm2f_tpu.losses import weaksup as jw
from bm2f_tpu.losses import weaksup_video as jwv
from bm2f_tpu.losses.criterion import SetCriterionConfig as JaxCriterionConfig
from bm2f_tpu.matching.hungarian import assign_fn_default
from bm2f_tpu.models.maskformer import normalize_images as jax_normalize_images
from bm2f_tpu.train.trainer import criterion_config as jax_criterion_config
from bm2f_tpu.video import build_video_model as jax_build_video_model
from bm2f_tpu_torch.config import get_config
from bm2f_tpu_torch.losses import target_prep as tp
from bm2f_tpu_torch.losses import weaksup_video as twv
from bm2f_tpu_torch.losses.criterion import SetCriterionConfig
from bm2f_tpu_torch.matching.hungarian import assign
from bm2f_tpu_torch.train.trainer import Trainer
from bm2f_tpu_torch.utils.convert_weights import jax_tree_to_numpy, jax_variables_to_state_dict
from test_torch_weaksup import CS_ATOL, blocky_images, rect_masks
from torch_port_utils import SMALL, randomize, to_numpy_tree

RTOL, ATOL = 1e-5, 1e-6
BOUNDS = ("left_bounds", "right_bounds", "top_bounds", "bottom_bounds")
SUP_TYPES = ("mask_projection", "mask_projection_and_spatial_pairwise",
             "mask_projection_and_spatial_pairwise_and_temporal_pairwise")


def T(x):
    return torch.from_numpy(np.array(x))


def J(x):
    return jnp.asarray(np.asarray(x))


# -- temporal pairs -------------------------------------------------------------------

HP, WP, NP = 6, 8, 20


def _boxes(rng, n):
    """(n, 2, HP, WP) boxes at t and t+1: random rectangles; case 0 has an
    empty box at t+1 (no source finds a match), case 1 a full box."""
    boxes = np.zeros((n, 2, HP, WP), bool)
    for i in range(n):
        for f in range(2):
            y0, x0 = rng.randint(0, HP - 2), rng.randint(0, WP - 2)
            boxes[i, f, y0:y0 + rng.randint(2, HP - y0 + 1), x0:x0 + rng.randint(2, WP - x0 + 1)] = 1
    boxes[0, 1] = False
    boxes[1] = True
    return boxes


def _features(kind, rng, n, C=16):
    if kind == "random":
        return rng.randn(n, 2, HP, WP, C).astype(np.float32)
    if kind == "zero":
        return np.zeros((n, 2, HP, WP, C), np.float32)
    # small integers: every distance exact in f32, many of them equal
    return rng.randint(-2, 3, (n, 2, HP, WP, C)).astype(np.float32)


@pytest.mark.parametrize("color", [False, True], ids=["no_color", "color"])
@pytest.mark.parametrize("kind", ["random", "zero", "integer"])
def test_compute_temporal_pairs_matches_jax(kind, color):
    rng = np.random.RandomState(["random", "zero", "integer"].index(kind))
    n = 5
    feats, boxes = _features(kind, rng, n), _boxes(rng, n)
    # LAB-like colors: 2x2-patch blocks of one color, half of them the same
    # in the next frame, so that the filter keeps some pairs and drops
    # others, far from its threshold
    blocks = rng.rand(n, 2, 3, 4, 3) * 60
    blocks[:, 1] = np.where(rng.rand(n, 3, 4, 1) < 0.5, blocks[:, 0], blocks[:, 1])
    lab = np.repeat(np.repeat(blocks, 2, 2), 2, 3).astype(np.float32)
    labs = (lab[:, 0], lab[:, 1]) if color else (None, None)

    def one(fc, fn, bc, bn, lc=None, ln=None):
        return jwv.compute_temporal_pairs(fc, fn, bc, bn, NP, lc, ln, 0.3)

    args = [J(feats[:, 0]), J(feats[:, 1]), J(boxes[:, 0]), J(boxes[:, 1])]
    if color:
        want = jax.jit(jax.vmap(one))(*args, J(labs[0]), J(labs[1]))
    else:
        want = jax.jit(jax.vmap(one))(*args)
    pairs, valid = twv.compute_temporal_pairs(
        T(feats[:, 0]), T(feats[:, 1]), T(boxes[:, 0]), T(boxes[:, 1]), NP,
        None if labs[0] is None else T(labs[0]), None if labs[1] is None else T(labs[1]), 0.3)
    assert pairs.dtype == torch.int32 and pairs.shape == (n, NP, 4)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(pairs.numpy(), np.asarray(want[0]))
    v = valid.numpy()
    assert not v[0].any()  # no box at t+1: no pair
    assert v.any() and not v.all()
    if kind == "zero" and not color:
        # all ties: the first in-box sources, each matched to the first
        # in-box patch of the next frame
        src = pairs.numpy()[1, :, 1] * WP + pairs.numpy()[1, :, 0]
        np.testing.assert_array_equal(src[v[1]], np.arange(v[1].sum()))


def _pair_case(seed=0, N=4, Tn=3, h=12, w=10, Kp=7):
    rng = np.random.RandomState(seed)
    masks = (rng.randn(N, Tn, h, w) * 3).astype(np.float32)
    pairs = np.stack([rng.randint(0, w, (N, Tn - 1, Kp)), rng.randint(0, h, (N, Tn - 1, Kp)),
                      rng.randint(0, w, (N, Tn - 1, Kp)), rng.randint(0, h, (N, Tn - 1, Kp))],
                     -1).astype(np.int32)
    valid = rng.rand(N, Tn - 1, Kp) > 0.3
    return masks, pairs, valid


def test_temporal_pairwise_loss_and_gradient_match_jax():
    masks, pairs, valid = _pair_case()
    want, jgrad = jax.jit(jax.value_and_grad(
        lambda m: jwv.temporal_pairwise_loss(m, J(pairs), J(valid), 0.5)))(J(masks))
    m = T(masks).requires_grad_()
    got = twv.temporal_pairwise_loss(m, T(pairs), T(valid), 0.5)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(jgrad), rtol=RTOL, atol=1e-7)
    # the per-pair -log P(same) of one frame pair
    one = twv.temporal_pair_log_same(T(masks[:, 0]), T(masks[:, 1]), T(pairs[:, 0]))
    ref = jax.jit(jax.vmap(jwv.temporal_pair_log_same))(J(masks[:, 0]), J(masks[:, 1]),
                                                        J(pairs[:, 0]))
    np.testing.assert_allclose(one.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


# -- the targets --------------------------------------------------------------------------

B, G, TN, H, W = 2, 4, 3, 64, 64


def _clip_batch(rng, feats=True):
    """Blocky clips whose blocks move one block to the right a frame, and
    DINO-like (B, T, 16, 16, 16) grids (the mapper's grid) that move with
    them (a patch keeps its feature), with 1 of clip 0's 4 targets
    padding. The features are small integers: a patch and its copy in the
    next frame are at distance exactly 0 in both frameworks (with
    continuous features the copies' distances are f32 rounding noise, and
    their order among equal-quality matches is each library's own)."""
    first = blocky_images(rng, B, H, W + 16 * TN)
    images = np.stack([first[:, :, 16 * (TN - t):16 * (TN - t) + W] for t in range(TN)], 1)
    valid = np.array([[1, 1, 1, 0], [1, 1, 1, 1]], bool)
    masks = np.stack([rect_masks(np.random.RandomState(7), B, G, H, W)] * TN, 2)
    masks = masks * valid[:, :, None, None, None]
    base = rng.randint(-2, 3, (B, 16, 16 + 4 * TN, 16)).astype(np.float32)
    dino = np.stack([base[:, :, 4 * (TN - t):4 * (TN - t) + 16] for t in range(TN)], 1)
    batch = {"images": images, "labels": np.where(valid, rng.randint(0, 40, (B, G)), -1)
             .astype(np.int32), "masks": masks.astype(np.float32), "valid": valid}
    if feats:
        batch["dino_feats"] = dino
    return batch


def test_build_video_weaksup_targets_matches_jax():
    batch = _clip_batch(np.random.RandomState(2))
    args = [batch[k] for k in ("images", "labels", "masks", "valid", "dino_feats")]
    want = jax.jit(jax_tp.build_video_weaksup_targets)(*map(J, args))
    got = tp.build_video_weaksup_targets(*map(T, args))
    assert set(got) == set(want)
    for k in ("labels", "valid", "box_masks", *BOUNDS, "temporal_pairs",
              "temporal_pairs_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["temporal_pairs"].shape == (B, G, TN - 1, 128, 4)
    np.testing.assert_allclose(got["color_similarity"].numpy(),
                               np.asarray(want["color_similarity"]), rtol=0, atol=CS_ATOL)
    pv = got["temporal_pairs_valid"].numpy()
    assert pv.any() and not pv[0, 3].any()  # the padding target has no pair
    # without features: no pairs
    assert "temporal_pairs" not in tp.build_video_weaksup_targets(*map(T, args[:4]))


# -- the weak video matcher and criterion -------------------------------------------------


@pytest.fixture(scope="module")
def criterion_case():
    """Random final + 2 aux layers (B=2, Q=6, T=3, 16x16 masks), targets of
    the JAX `build_video_weaksup_targets`."""
    rng = np.random.RandomState(9)
    Q, K, L = 6, 40, 2
    outs = {"pred_logits": rng.randn(B, Q, K + 1), "pred_masks": rng.randn(B, Q, TN, 16, 16) * 3,
            "aux_logits": rng.randn(L, B, Q, K + 1), "aux_masks": rng.randn(L, B, Q, TN, 16, 16) * 3}
    outs = {k: v.astype(np.float32) for k, v in outs.items()}
    batch = _clip_batch(rng)
    targets = jax.jit(jax_tp.build_video_weaksup_targets)(
        *(J(batch[k]) for k in ("images", "labels", "masks", "valid", "dino_feats")))
    return outs, {k: np.asarray(v) for k, v in targets.items()}, K


@pytest.mark.parametrize("sup_type", SUP_TYPES, ids=["proj", "spatpair", "spatpair_temppair"])
def test_video_weaksup_criterion_matches_jax(criterion_case, sup_type):
    """The costs of every layer (through the assign functions), equal
    assignments, every loss, the total and the gradients of the outputs."""
    outs, targets, K = criterion_case
    kw = dict(sup_type=sup_type, projection_weight=5.0, pairwise_weight=2.0,
              temporal_pairwise_weight=2.0, color_thresh=0.3, kernel_size=3, dilation=2,
              warmup_factor=0.5)

    def f(o):
        seen = []

        def jassign(c):
            seen.append(c)
            return assign_fn_default(c)

        total, losses = jwv.video_weaksup_set_criterion(
            o, {k: J(v) for k, v in targets.items()}, JaxCriterionConfig(num_classes=K),
            None, assign_fn=jassign, **kw)
        return total, (losses, seen[0])

    (jtotal, (jlosses, jcosts)), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        {k: J(v) for k, v in outs.items()})
    seen = {}

    def tassign(c):
        seen["costs"], seen["asg"] = c, assign(c)
        return seen["asg"]

    o = {k: T(v).requires_grad_() for k, v in outs.items()}
    total, losses = twv.video_weaksup_set_criterion(
        o, {k: T(v) for k, v in targets.items()}, SetCriterionConfig(num_classes=K),
        assign_fn=tassign, **kw)
    total.backward()

    np.testing.assert_allclose(seen["costs"].numpy(), np.asarray(jcosts), rtol=RTOL, atol=1e-5)
    np.testing.assert_array_equal(seen["asg"].numpy(), np.asarray(assign_fn_default(jcosts)))
    assert set(losses) == set(jlosses)
    for k, v in jlosses.items():
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=RTOL, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=RTOL)
    for k in ("spatial_pairwise", "temporal_pairwise"):
        if k in sup_type:
            assert losses[f"loss_mask_{k}"].item() > 0
    for k in outs:
        np.testing.assert_allclose(o[k].grad.numpy(), np.asarray(jgrads[k]), rtol=RTOL,
                                   atol=1e-7, err_msg=k)


# -- the SMALL weak temporal step --------------------------------------------------------------

TEMP = "ytvis2021_video_r50_proj_spatpair_temppair"
# step 5 of 10: pairwise warmup 0.5
STEP_OVER = {**SMALL, "model.decoder.dec_layers": 3, "input.max_instances": 4,
             "model.loss.weak.pairwise.warmup_iters": 10}
STEP = 5


@pytest.fixture(scope="module")
def temporal_step():
    """The SMALL video model on 2 moving blocky clips of 3 frames at 64x64
    with DINO grids: JAX's value_and_grad of build_video_weaksup_targets +
    video_weaksup_set_criterion at STEP, and the port's Trainer at
    step_count STEP."""
    jcfg = jax_get_config(TEMP, STEP_OVER)
    jmodel = jax_build_video_model(jcfg)
    variables = to_numpy_tree(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 64, 64, 3), jnp.float32)))
    variables = randomize(variables, np.random.RandomState(5), 0.05,
                          only=lambda p: "sampling_offsets" in p or "attention_weights" in p)
    batch = _clip_batch(np.random.RandomState(10))
    weak = jcfg.model.loss.weak
    warm = jw.pairwise_warmup_factor(jnp.asarray(STEP), weak.pairwise.warmup_iters)
    assert float(warm) == 0.5

    def loss_fn(p):
        out = jmodel.apply({"params": p, "frozen": variables["frozen"]},
                           jax_normalize_images(J(batch["images"]), jcfg.model))
        targets = jax_tp.build_video_weaksup_targets(
            *(J(batch[k]) for k in ("images", "labels", "masks", "valid", "dino_feats")))
        return jwv.video_weaksup_set_criterion(
            out, targets, jax_criterion_config(jcfg), None, sup_type=jcfg.model.loss.sup_type,
            projection_weight=weak.projection_weight, pairwise_weight=weak.pairwise_weight,
            temporal_pairwise_weight=weak.temporal_pairwise_weight,
            color_thresh=weak.pairwise.color_thresh, warmup_factor=warm)

    (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, variables["params"]))

    cfg = get_config(TEMP, STEP_OVER)
    trainer = Trainer(cfg, device="cpu")
    trainer.model.load_state_dict(jax_variables_to_state_dict(variables, cfg), strict=True)
    trainer.optimizer.count = STEP
    metrics = trainer.step({k: T(v) for k, v in batch.items()})
    ref = {"losses": {k: float(v) for k, v in jlosses.items()}, "total": float(jtotal),
           "grad_norm": float(optax.global_norm(jgrads)),
           "grads": jax_tree_to_numpy({"params": jgrads})}
    return ref, metrics, trainer


def test_small_temporal_step_losses_match_jax(temporal_step):
    ref, metrics, _ = temporal_step
    assert set(metrics) == set(ref["losses"]) | {"total_loss", "grad_norm"}
    for k, v in ref["losses"].items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("loss_mask_projection", "loss_mask_spatial_pairwise",
              "loss_mask_temporal_pairwise", "temp_pair_valid_prop"):
        assert ref["losses"][k] > 0, k
    np.testing.assert_allclose(metrics["total_loss"].item(), ref["total"], rtol=1e-4)
    np.testing.assert_allclose(metrics["grad_norm"].item(), ref["grad_norm"], rtol=1e-3)


def test_small_temporal_step_gradients_match_jax(temporal_step):
    """Every parameter's gradient within a norm-relative 1e-3, the
    deformable projections included."""
    ref, _, trainer = temporal_step
    checked = 0
    for name, p in trainer.model.named_parameters():
        want = ref["grads"][name]
        err = np.linalg.norm(p.grad.numpy() - want)
        assert err <= 1e-3 * np.linalg.norm(want) + 1e-12, (name, err, np.linalg.norm(want))
        checked += ".self_attn.sampling_offsets." in name and np.linalg.norm(want) > 0
    assert checked == 4  # weight and bias of both encoder layers
